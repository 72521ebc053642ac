"""The port's circuit simulator against the JAX package's, on the same
seeded inputs: time encoding, current programming (Eq. 5-7), the
non-ideality models, every VMM variant and the two-layer perceptron.

Elementwise float32 functions are compared bitwise.  Reductions (means and
sums of currents) and transcendental functions run in another order or
another library, so they are held within a few float32 ulps.  The VMMs
differ by solver: the JAX package's exact sort-based crossing against the
port's bisection over [0, 2T] (24 steps: 2^-23 of T), both in float32, so
decoded outputs are held within TD_ATOL."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import currents as jcur
from repro.core import encoding as jenc
from repro.core import nonideal as jni
from repro.core import tdcore as jtd
from repro.core.constants import TDVMMSpec as JSpec
from repro_torch.core import currents as tcur
from repro_torch.core import encoding as tenc
from repro_torch.core import nonideal as tni
from repro_torch.core import tdcore as ttd
from repro_torch.core.constants import TDVMMSpec as TSpec

# float32 reductions in another order, and pow/exp/log2 from another
# library: a few float32 ulps
RTOL = 2e-6
# decoded VMM outputs, port (bisection) against the JAX package (exact) and
# against the closed form in float64: the last bracket (2^-23 of T) plus
# float32 rounding of onsets, currents and charge sums; measured <= 1.2e-6
# against the JAX package and <= 7.6e-7 against the closed form; ~2x that,
# below the midpoint error of a bisection cut to 18 steps (up to 3.8e-6 T)
TD_ATOL = 2.5e-6


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


def _np(x):
    return np.asarray(x)


def _rng(seed):
    return np.random.default_rng(seed)


# --------------------------------------------------------------------------
# encoding
# --------------------------------------------------------------------------
T = TSpec(bits=6).t_window_s
ENCODING = {
    "dequantize_code": (lambda m, x: m.dequantize_code(m.quantize_code(x, 6), 6)),
    "fake_quant": (lambda m, x: m.fake_quant(x, 5)),
    "value_to_onset": (lambda m, x: m.value_to_onset(x, T)),
    "onset_to_value": (lambda m, x: m.onset_to_value(x * T, T)),
    "crossing_to_value": (lambda m, x: m.crossing_to_value((1.5 + x) * T, T)),
    "value_to_duration": (lambda m, x: m.value_to_duration(x, T)),
    "duration_to_value": (lambda m, x: m.duration_to_value(x * T, T)),
    "four_quadrant_split": (lambda m, x: m.four_quadrant_split(x)),
    "four_quadrant_merge": (lambda m, x: m.four_quadrant_merge(x, x * x)),
}


@pytest.mark.parametrize("name", sorted(ENCODING))
def test_encoding_bitwise(name):
    x = _rng(1).uniform(-1.2, 1.2, (257,)).astype(np.float32)
    fn = ENCODING[name]
    want = fn(jenc, jnp.asarray(x))
    got = fn(tenc, torch.from_numpy(x))
    for g, w in zip(*(v if isinstance(v, tuple) else (v,)
                      for v in (got, want))):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), _np(w))


# --------------------------------------------------------------------------
# current programming (Eq. 5-7)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_in,n_out", [(10, 10), (33, 7), (128, 64)])
def test_programming_matches_reference(n_in, n_out):
    rng = _rng(n_in + n_out)
    w = rng.uniform(-1.0, 1.0, (n_in, n_out)).astype(np.float32)
    wp = np.abs(w)
    i_max, w_max = 1e-6, 1.0
    got = tcur.program_matrix(torch.from_numpy(wp), i_max, w_max)
    want = jcur.program_matrix(jnp.asarray(wp), i_max, w_max)
    for g, v in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(v), rtol=RTOL, atol=0)
    got = tcur.program_column(torch.from_numpy(wp[:, 0]), i_max, w_max)
    want = jcur.program_column(jnp.asarray(wp[:, 0]), i_max, w_max)
    for g, v in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(v), rtol=RTOL, atol=0)
    got = tcur.four_quadrant_program(torch.from_numpy(w), i_max, w_max)
    want = jcur.four_quadrant_program(jnp.asarray(w), i_max, w_max)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), _np(want[k]), rtol=RTOL,
                                   atol=0)
    for g, v in zip(tcur.four_quadrant_weights(torch.from_numpy(w)),
                    jcur.four_quadrant_weights(jnp.asarray(w))):
        np.testing.assert_array_equal(g.numpy(), _np(v))


@pytest.mark.parametrize("bits", [3, 6, 8])
def test_quantize_weights_bitwise(bits):
    # half-way magnitudes included: both round half to even
    levels = (1 << bits) - 1
    w = np.concatenate([
        _rng(bits).uniform(-1.3, 1.3, (200,)),
        (np.arange(levels) + 0.5) / levels * np.where(
            np.arange(levels) % 2, 1.0, -1.0)]).astype(np.float32)
    got = tcur.quantize_weights(torch.from_numpy(w), bits, 1.0)
    want = jcur.quantize_weights(jnp.asarray(w), bits, 1.0)
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("seed", range(4))
def test_programming_invariants(seed):
    """0 <= I <= I_max and every bias >= 0, for weights in [0, w_max].  A
    column of w_max alone programs I_max everywhere and a bias of exactly 0,
    which a float32 sum of N currents can miss by up to N * (N I_max) 2^-24
    (half of that after Eq. 7's factor 1/2)."""
    rng = _rng(seed)
    n_in, n_out = int(rng.integers(2, 80)), int(rng.integers(1, 20))
    w_max, i_max = float(rng.uniform(0.5, 2.0)), 1e-6
    w = rng.uniform(0.0, w_max, (n_in, n_out)).astype(np.float32)
    w[:, 0] = w_max                                   # a full column
    i_mat, bias = tcur.program_matrix(torch.from_numpy(w), i_max, w_max)
    floor = -0.5 * n_in * n_in * i_max * 2.0 ** -24
    assert bool((i_mat >= 0).all()) and bool((i_mat <= i_max * (1 + 1e-6)).all())
    assert bool((bias >= floor).all()) and bool((bias[1:] >= 0).all())
    prog = tcur.four_quadrant_program(torch.from_numpy(w * 2 - w_max),
                                      i_max, w_max)
    for k in ("pos", "neg"):
        assert bool((prog[k] >= 0).all())
        assert bool((prog[k] <= i_max * (1 + 1e-6)).all())
    assert bool((prog["bias_pos"] >= floor).all())
    assert bool((prog["bias_neg"] >= floor).all())


# --------------------------------------------------------------------------
# non-idealities
# --------------------------------------------------------------------------
V_SG = [0.6, 0.7, 0.8, 0.9, 1.0]
I_MAX = [1e-8, 1e-7, 5e-7, 1e-6, 2e-6]


@pytest.mark.parametrize("v_sg", V_SG)
def test_dibl_models_match_reference_on_the_grid(v_sg):
    i_max = np.asarray(I_MAX, np.float32)
    lam_t = tni.dibl_lambda(torch.from_numpy(i_max), v_sg)
    lam_j = jni.dibl_lambda(jnp.asarray(i_max), jnp.float32(v_sg))
    np.testing.assert_allclose(lam_t.numpy(), _np(lam_j), rtol=RTOL)
    err_t = tni.relative_error(torch.from_numpy(i_max), v_sg, 0.2)
    err_j = jni.relative_error(jnp.asarray(i_max), jnp.float32(v_sg),
                               jnp.float32(0.2))
    # a difference of two currents, each within a few ulps: an absolute
    # bound (relative to the error itself it grows as 1/error)
    np.testing.assert_allclose(err_t.numpy(), _np(err_j), rtol=0,
                               atol=1e-6)
    v_d = np.linspace(0.3, 0.7, 9, dtype=np.float32)
    np.testing.assert_allclose(
        tni.drain_current(1e-6, torch.from_numpy(v_d), lam_t[3]).numpy(),
        _np(jni.drain_current(1e-6, jnp.asarray(v_d), lam_j[3])), rtol=RTOL)


def test_effective_bits_matches_reference():
    err = np.asarray([1e-13, 1e-4, 0.003, 0.0078125, 0.01, 0.019, 0.02,
                      0.0625, 0.3, 1.0], np.float32)
    np.testing.assert_array_equal(
        tni.effective_bits(torch.from_numpy(err)).numpy(),
        _np(jni.effective_bits(jnp.asarray(err))))
    # the paper's anchor: < 2% at the optimum, at least 5 bits
    spec = TSpec()
    e = tni.relative_error(spec.i_max, spec.v_sg, spec.delta_vd)
    assert float(e) < 0.02 and float(tni.effective_bits(e)) >= 5


def _currents(seed=0, shape=(200, 200)):
    return torch.from_numpy(_rng(seed).uniform(1e-8, 1e-6, shape)
                            .astype(np.float32))


def test_perturb_currents_dibl_only_within_the_error():
    spec = TSpec()
    cfg = tni.NonIdealityConfig(dibl=True, weight_noise=False)
    i_mat = _currents()
    eff = tni.perturb_currents(i_mat, torch.Generator().manual_seed(0), spec,
                               cfg)
    err = float(tni.relative_error(spec.i_max, spec.v_sg, spec.delta_vd))
    ratio = (eff / i_mat - 1.0).abs()
    assert float(ratio.max()) <= err * (1 + 1e-5)
    assert float(ratio.max()) > 0.9 * err              # the band is used
    # the JAX package's draw: the same band, both centred
    j_eff = _np(jni.perturb_currents(jnp.asarray(i_mat.numpy()),
                                     jax.random.PRNGKey(0), JSpec(), cfg))
    j_ratio = j_eff / i_mat.numpy() - 1.0
    assert np.abs(j_ratio).max() <= err * (1 + 1e-5)
    for r in (float((eff / i_mat - 1.0).mean()), float(j_ratio.mean())):
        assert abs(r) < 5 * err / np.sqrt(3 * i_mat.numel())


def test_perturb_currents_weight_noise_is_lognormal_sigma():
    spec = TSpec()
    cfg = tni.NonIdealityConfig(dibl=False, weight_noise=True)
    i_mat = _currents(1)
    n = i_mat.numel()
    eff = tni.perturb_currents(i_mat, torch.Generator().manual_seed(1), spec,
                               cfg)
    j_eff = _np(jni.perturb_currents(jnp.asarray(i_mat.numpy()),
                                     jax.random.PRNGKey(1), JSpec(), cfg))
    for lr in (torch.log(eff / i_mat).double().numpy(),
               np.log(j_eff / i_mat.numpy()).astype(np.float64)):
        assert abs(lr.mean()) < 5 * cfg.sigma_tune / np.sqrt(n)
        assert abs(lr.std() / cfg.sigma_tune - 1.0) < 0.03


def test_perturb_currents_uncompensated_shifts_the_mean():
    spec = TSpec()
    cfg = tni.NonIdealityConfig(dibl=True, weight_noise=False,
                                compensate_systematic=False)
    i_mat = _currents(2)
    eff = tni.perturb_currents(i_mat, torch.Generator().manual_seed(2), spec,
                               cfg)
    err = float(tni.relative_error(spec.i_max, spec.v_sg, spec.delta_vd))
    mean = float((eff / i_mat - 1.0).double().mean())
    assert abs(mean - 0.5 * err) < 0.05 * err


def test_perturb_currents_same_seed_same_tensor():
    spec, cfg = TSpec(), tni.NonIdealityConfig()
    i_mat = _currents(3, (17, 9))
    a = tni.perturb_currents(i_mat, torch.Generator().manual_seed(5), spec, cfg)
    b = tni.perturb_currents(i_mat, torch.Generator().manual_seed(5), spec, cfg)
    c = tni.perturb_currents(i_mat, torch.Generator().manual_seed(6), spec, cfg)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_latch_time_offset_statistics_match_reference():
    spec = TSpec()
    n_inputs, shape = 100, (100_000,)
    got = tni.latch_time_offset(torch.Generator().manual_seed(0), shape,
                                n_inputs, spec).double().numpy()
    want = _np(jni.latch_time_offset(jax.random.PRNGKey(0), shape, n_inputs,
                                     JSpec())).astype(np.float64)
    sigma = spec.c_total_f(n_inputs) * 0.020 / (n_inputs * spec.i_max)
    for d in (got, want):
        assert abs(d.mean()) < 5 * sigma / np.sqrt(shape[0])
        assert abs(d.std() / sigma - 1.0) < 0.02


# --------------------------------------------------------------------------
# the simulator
# --------------------------------------------------------------------------
def _signed(rng, shape):
    return rng.uniform(-1.0, 1.0, shape).astype(np.float32)


def test_crossing_time_matches_reference():
    rng = _rng(3)
    t_on = rng.uniform(0.0, 1.0, (40,)).astype(np.float32)
    i_src = rng.uniform(0.01, 1.0, (40,)).astype(np.float32)
    got = ttd.crossing_time(torch.from_numpy(t_on), torch.from_numpy(i_src),
                            5.0)
    want = jtd.crossing_time(jnp.asarray(t_on), jnp.asarray(i_src), 5.0)
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


VMMS = {
    # name: (port function, JAX function, ideal name, input range)
    "single": (ttd.td_vmm_single_quadrant, jtd.td_vmm_single_quadrant,
               "ideal_single_quadrant", (0.0, 1.0)),
    "four": (ttd.td_vmm_four_quadrant, jtd.td_vmm_four_quadrant,
             "ideal_four_quadrant", (-1.0, 1.0)),
    "two": (ttd.td_vmm_two_quadrant, jtd.td_vmm_two_quadrant,
            "ideal_two_quadrant", (0.0, 1.0)),
}


@pytest.mark.parametrize("bits", [6, 8])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("name", sorted(VMMS))
def test_vmm_matches_reference_and_closed_form(name, batched, bits):
    fn_t, fn_j, ideal, (lo, hi) = VMMS[name]
    rng = _rng(bits * 10 + len(name))
    n_in, n_out, b = 24, 7, 5
    w = rng.uniform(0.0 if name == "single" else -1.0, 1.0,
                    (n_in, n_out)).astype(np.float32)
    x = rng.uniform(lo, hi, (b, n_in) if batched else (n_in,)).astype(
        np.float32)
    got = fn_t(torch.from_numpy(x), torch.from_numpy(w), TSpec(bits=bits))
    want = (jax.vmap(lambda r: fn_j(r, jnp.asarray(w), JSpec(bits=bits)))(
        jnp.asarray(x)) if batched else fn_j(jnp.asarray(x), jnp.asarray(w),
                                             JSpec(bits=bits)))
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape[:-1] + (n_out,)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TD_ATOL, rtol=0)
    closed = getattr(ttd, ideal)(torch.from_numpy(x).double(),
                                 torch.from_numpy(w).double(), 1.0)
    np.testing.assert_allclose(got.numpy(), closed.numpy(), atol=TD_ATOL,
                               rtol=0)
    np.testing.assert_allclose(
        getattr(ttd, ideal)(torch.from_numpy(x), torch.from_numpy(w),
                            1.0).numpy(),
        _np(getattr(jtd, ideal)(jnp.asarray(x), jnp.asarray(w), 1.0))
        if not batched else _np(jax.vmap(lambda r: getattr(jtd, ideal)(
            r, jnp.asarray(w), 1.0))(jnp.asarray(x))), rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("name", ["four", "two"])
def test_vmm_crossing_times_match_reference(name):
    fn_t, fn_j, _, (lo, hi) = VMMS[name]
    rng = _rng(len(name))
    w = _signed(rng, (16, 6))
    x = rng.uniform(lo, hi, (16,)).astype(np.float32)
    spec_t, spec_j = TSpec(bits=6), JSpec(bits=6)
    _, (tp, tm) = fn_t(torch.from_numpy(x), torch.from_numpy(w), spec_t,
                       return_times=True)
    _, (jp, jm) = fn_j(jnp.asarray(x), jnp.asarray(w), spec_j,
                       return_times=True)
    for g, v in ((tp, jp), (tm, jm)):
        np.testing.assert_allclose(g.numpy() / spec_t.t_window_s,
                                   _np(v) / spec_t.t_window_s, atol=TD_ATOL,
                                   rtol=0)
    np.testing.assert_array_equal(
        ttd.relu_duration(tp, tm).numpy(),
        _np(jtd.relu_duration(jnp.asarray(tp.numpy()),
                              jnp.asarray(tm.numpy()))))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_mlp_forward_matches_reference_and_closed_form(seed, batched):
    rng = _rng(100 + seed)
    w1, w2 = _signed(rng, (10, 10)), _signed(rng, (10, 10))
    x = _signed(rng, (8, 10) if batched else (10,))
    spec_t, spec_j = TSpec(bits=6), JSpec(bits=6)
    got = ttd.td_mlp_forward(
        torch.from_numpy(x), torch.from_numpy(w1), torch.from_numpy(w2),
        spec_t)
    args = (jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2), spec_j)
    want = (jtd.td_mlp_forward_batched(*args) if batched
            else jtd.td_mlp_forward(*args))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TD_ATOL, rtol=0)
    ideal = ttd.ideal_mlp(*(torch.from_numpy(a).double() for a in (x, w1, w2)),
                          1.0)
    np.testing.assert_allclose(got.numpy(), ideal.numpy(), atol=TD_ATOL,
                               rtol=0)


def test_four_quadrant_batched_matches_reference():
    rng = _rng(9)
    w, x = _signed(rng, (12, 5)), _signed(rng, (6, 12))
    got = ttd.td_vmm_four_quadrant(torch.from_numpy(x), torch.from_numpy(w),
                                   TSpec())
    want = jtd.td_vmm_four_quadrant_batched(jnp.asarray(x), jnp.asarray(w),
                                            JSpec())
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TD_ATOL, rtol=0)


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("n_stages,n_samples", [(1, 1), (2, 64), (5, 1000)])
def test_pipeline_schedule_equal(n_stages, n_samples, bits):
    assert ttd.pipeline_schedule(n_stages, n_samples, TSpec(bits=bits)) == \
        jtd.pipeline_schedule(n_stages, n_samples, JSpec(bits=bits))
