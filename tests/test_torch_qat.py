"""QAT through the port's TD-VMM path against the JAX package: the
straight-through estimators of the code stages, programming noise fed the
reference's own draws, the custom gradient of the integrate stage in every
kernel mode, td_matmul / td_grouped_matmul / td_expert_matmul forward and
backward, and the card's 3xTF32 arithmetic (B1/B2's storage for float32
codes off the integer grid) emulated on the CPU at qwen's QAT shapes.

The reference runs with ``backend="jnp"`` (its Pallas B2 fails under this
jax); the port's wrappers take their plain versions for CPU tensors."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TDVMMLayerConfig as JLayer
from repro.core import layers as jlayers
from repro.core import quant as jquant
from repro.core.constants import TDVMMSpec as JSpec
from repro.kernels.tdvmm import ops as jops
from repro_torch.configs import TDVMMLayerConfig as TLayer
from repro_torch.core import layers as tlayers
from repro_torch.core import quant as tquant
from repro_torch.core.constants import TDVMMSpec as TSpec
from repro_torch.kernels.tdvmm import ops as tops
from repro_torch.kernels.tdvmm import tdvmm as tk

# Gradients, port against the JAX package, max|g_port - g_ref| over max|g_ref|
# per operand: the codes and the forward are bitwise equal; the backward's
# float32 products (x and w cotangents) and sums (scale cotangents) add in
# another order than XLA's.  Measured <= 3.5e-7 at these shapes.
GRAD_RTOL = 1e-5
# programming noise fed the same draws: the DIBL error and exp() may round
# differently in the two packages' float32 (2 ulp of each code)
NOISE_ULPS = 2


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else float(
        np.abs(a).max())


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# ---------------------------------------------------------------------------
# Straight-through estimators of the code stages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [6, 8])
def test_encode_input_ste_gradient_matches_reference(bits):
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((5, 24)).astype(np.float32)
    c = rng.standard_normal((5, 24)).astype(np.float32)

    def jf(x):
        return jnp.sum(jquant.encode_input(x, bits).dequantize() * c)
    gj = jax.grad(jf)(jnp.asarray(x))
    xt = _t(x, True)
    q = tquant.encode_input(xt, bits)
    # the port keeps no dequantize(): view() / L * scale is the same value
    value = q.view() * (q.scale / float(q.levels))
    torch.sum(value * torch.from_numpy(c)).backward()
    # the forward value is the stored code, bit for bit
    qj = jquant.encode_input(jnp.asarray(x), bits)
    assert np.array_equal(q.view().detach().numpy(), np.asarray(qj.view()))
    assert not q.scale.requires_grad
    assert _rel(xt.grad.numpy(), gj) <= 1e-6


@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("bits", [6, 8])
def test_program_weights_ste_gradient_matches_reference(bits, per_channel):
    rng = np.random.default_rng(bits + per_channel)
    w = rng.standard_normal((24, 10)).astype(np.float32)
    c = rng.standard_normal((24, 10)).astype(np.float32)

    def jf(w):
        return jnp.sum(jquant.program_weights(w, bits, per_channel).view() * c)
    gj = jax.grad(jf)(jnp.asarray(w))
    wt = _t(w, True)
    q = tquant.program_weights(wt, bits, per_channel)
    torch.sum(q.view() * torch.from_numpy(c)).backward()
    # max-magnitude weights keep their full gradient: no clip in the STE
    assert _rel(wt.grad.numpy(), gj) <= 1e-6


def test_view_keeps_the_integer_code_and_passes_identity():
    x = torch.tensor([[0.3, -0.71, 0.5, 1.0]], requires_grad=True)
    q = tquant.encode_input(x, 6)
    assert q.codes.dtype == torch.int8 and q.ste is not None
    v = q.view()
    assert torch.equal(v.detach(), q.codes.to(torch.float32))
    v.sum().backward()
    # d(code)/dx = L / s, s = max|x| = 1
    assert torch.allclose(x.grad, torch.full_like(x, 63.0))
    # no gradient wanted: no linear term is kept
    assert tquant.encode_input(x.detach(), 6).ste is None


# ---------------------------------------------------------------------------
# Programming noise
# ---------------------------------------------------------------------------
def _ref_draws(key, shape):
    """The two draws of the JAX package's program_noise for ``key``."""
    k1, k2 = jax.random.split(key)
    u = jax.random.uniform(k1, shape, jnp.float32, minval=-1.0, maxval=1.0)
    n = jax.random.normal(k2, shape, jnp.float32)
    return tquant.NoiseDraws(_t(u), _t(n))


@pytest.mark.parametrize("bits", [6, 8])
def test_program_noise_fed_reference_draws_within_2_ulp(bits):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((32, 20)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    qj = jquant.program_noise(jquant.program_weights(jnp.asarray(w), bits),
                              JSpec(), key)
    qt = tquant.program_noise(tquant.program_weights(_t(w), bits), TSpec(),
                              _ref_draws(key, w.shape))
    a, b = qt.codes.numpy(), np.asarray(qj.codes)
    assert qt.codes.dtype == torch.float32
    assert np.all(np.abs(a - b) <= NOISE_ULPS * np.spacing(np.abs(b)))
    # off the integer grid, as analog currents are
    assert not np.array_equal(a, np.round(a))


def test_program_noise_draws_depend_on_the_key_alone():
    w = torch.linspace(-1, 1, 60).reshape(6, 10)
    q = tquant.program_weights(w, 6)
    a = tquant.program_noise(q, TSpec(), 11).codes
    assert torch.equal(a, tquant.program_noise(q, TSpec(), 11).codes)
    assert not torch.equal(a, tquant.program_noise(q, TSpec(), 12).codes)
    assert len(set(tquant.split_key(11, 3))) == 3
    assert tquant.split_key(11, 3) == tquant.split_key(11, 3)
    with pytest.raises(ValueError, match="noise draws"):
        tquant.program_noise(q, TSpec(), tquant.NoiseDraws(
            torch.zeros(3), torch.zeros(3)))
    with pytest.raises(TypeError, match="noise key"):
        tquant.program_noise(q, TSpec(), 1.5)


# ---------------------------------------------------------------------------
# The custom gradient of the integrate stage, every kernel mode
# ---------------------------------------------------------------------------
OPS_MODES = {
    # name: (x batch, w batch, M, K, N, tdvmm_matmul keywords)
    "raw": (1, 1, 6, 40, 24, dict()),
    "fixed_window": (1, 1, 6, 40, 24, dict(out_bits=6, out_scale=0.01)),
    "data_calibrated": (1, 1, 6, 40, 24, dict(out_bits=6)),
    "two_pass_calibrated": (1, 1, 6, 40, 24,
                            dict(out_bits=6, fused_calibration=False)),
    "runtime_window": (1, 1, 6, 40, 24, dict(out_bits=6, window=0.01)),
    "ragged_members": (1, 1, 6, 40, 256,
                       dict(out_bits=6, group_widths=(128, 128))),
    "ragged_member_windows": (1, 1, 6, 40, 256,
                              dict(out_bits=6, group_widths=(128, 128),
                                   out_scale=(0.01, 0.02))),
    "expert_batched": (3, 3, 5, 40, 24, dict(out_bits=6)),
    "expert_windows": (3, 3, 5, 40, 24,
                       dict(out_bits=6, out_scale=(0.01, 0.02, 0.015))),
    "shared_x": (1, 3, 5, 40, 24, dict(out_bits=6)),
}


def _codes(rng, shape, lim):
    return rng.integers(-lim, lim + 1, shape).astype(np.float32)


@pytest.mark.parametrize("mode", sorted(OPS_MODES))
def test_tdvmm_core_gradient_matches_reference_custom_vjp(mode):
    ex, e, m, k, n, kw = OPS_MODES[mode]
    kw = dict(kw)
    rng = np.random.default_rng(len(mode))
    x = _codes(rng, (ex, m, k), 63)
    w = _codes(rng, (e, k, n), 63)
    xs = (rng.random((ex, m)) + 0.5).astype(np.float32)
    ws = (rng.random((e, n)) + 0.5).astype(np.float32)
    g = rng.standard_normal((e, m, n)).astype(np.float32)
    gain = 1.0 / (63.0 * 63.0 * 2.0 * k)
    window = kw.pop("window", None)
    x2 = x[0] if mode in ("shared_x",) or kw.get("group_widths") else x
    w2 = w[0] if kw.get("group_widths") else w
    xs2 = xs[0] if x2.ndim == 2 else xs
    ws2 = ws[0] if w2.ndim == 2 else ws
    g2 = g[0] if (x2.ndim == 2 and w2.ndim == 2) else g

    def jf(a, b, c, d):
        jkw = dict(kw)
        if window is not None:
            jkw["out_window"] = jnp.float32(window)
        return jops.tdvmm_matmul(a, b, c, d, gain=gain, backend="jnp",
                                 code_dtype="int8", **jkw)
    yj, vjp = jax.vjp(jf, *(jnp.asarray(v) for v in (x2, w2, xs2, ws2)))
    gj = vjp(jnp.asarray(g2))
    ts = [_t(v, True) for v in (x2, w2, xs2, ws2)]
    tkw = dict(kw)
    if window is not None:
        tkw["out_window"] = torch.tensor(window, dtype=torch.float32)
    yt = tops.tdvmm_matmul(*ts, gain=gain, code_dtype="int8", **tkw)
    assert np.array_equal(yt.detach().numpy(), np.asarray(yj)), mode
    yt.backward(torch.from_numpy(g2))
    for name, a, b in zip(("x", "w", "x_scale", "w_scale"), ts, gj):
        assert _rel(a.grad.numpy(), b) <= GRAD_RTOL, (mode, name)


def test_tdvmm_core_gradient_is_the_formula_not_autograd_of_rounding():
    """Autograd through the readout's rint/clip would give zero; the
    straight-through formula gives dacc = g * xs * ws * gain."""
    x = torch.ones((1, 2, 4), requires_grad=True)
    w = torch.ones((1, 4, 3))
    xs, ws = torch.full((1, 2), 2.0), torch.full((1, 3), 3.0)
    y = tops.tdvmm_matmul(x, w, xs, ws, gain=0.25, out_bits=6,
                          code_dtype="int8")
    y.sum().backward()
    assert torch.allclose(x.grad, torch.full((1, 2, 4), 3 * 2 * 3 * 0.25))


@pytest.mark.parametrize("shared_x", [False, True])
def test_codes_matmul_gradient_matches_reference(shared_x):
    rng = np.random.default_rng(3)
    x = _codes(rng, (7, 33), 63)
    w = _codes(rng, (3, 33, 20) if shared_x else (33, 20), 63)
    g = rng.standard_normal((3, 7, 20) if shared_x else (7, 20)).astype(
        np.float32)
    yj, vjp = jax.vjp(lambda a, b: jops.codes_matmul(a, b, "jnp"),
                      jnp.asarray(x), jnp.asarray(w))
    gj = vjp(jnp.asarray(g))
    xt, wt = _t(x, True), _t(w, True)
    yt = tops.codes_matmul(xt, wt, "auto")
    assert np.array_equal(yt.detach().numpy(), np.asarray(yj))
    yt.backward(torch.from_numpy(g))
    assert _rel(xt.grad.numpy(), gj[0]) <= GRAD_RTOL
    assert _rel(wt.grad.numpy(), gj[1]) <= GRAD_RTOL


# ---------------------------------------------------------------------------
# The layers: forward bitwise, gradients through the STE to the weights
# ---------------------------------------------------------------------------
LAYER_CFGS = {
    "data_calibrated": dict(),
    "fixed_window": dict(out_scale=0.02),
    "no_readout": dict(io_quantize=False),
    "p8_f32_codes": dict(bits=8, weight_bits=8),
    "p4_per_tensor": dict(bits=4, weight_bits=5, per_channel=False),
}


def _loss_grads_jax(fn, *args):
    return jax.value_and_grad(lambda *a: jnp.sum(jnp.sin(fn(*a))),
                              argnums=tuple(range(len(args))))(*args)


def _loss_grads_torch(fn, *args):
    ts = [_t(a, True) for a in args]
    y = fn(*ts)
    torch.sum(torch.sin(y)).backward()
    return y.detach(), [t.grad for t in ts]


@pytest.mark.parametrize("site", sorted(LAYER_CFGS))
def test_td_matmul_forward_bitwise_and_gradients(site):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 40)) * 48 ** -0.5).astype(np.float32)
    jc = JLayer(enabled=True, backend="jnp", **LAYER_CFGS[site])
    tc = TLayer(enabled=True, **LAYER_CFGS[site])
    yj = jlayers.td_matmul(jnp.asarray(x), jnp.asarray(w), jc)
    _, gj = _loss_grads_jax(lambda a, b: jlayers.td_matmul(a, b, jc),
                            jnp.asarray(x), jnp.asarray(w))
    yt, gt = _loss_grads_torch(lambda a, b: tlayers.td_matmul(a, b, tc),
                               x, w)
    assert np.array_equal(yt.numpy(), np.asarray(yj))
    for a, b in zip(gt, gj):
        assert _rel(a.numpy(), b) <= GRAD_RTOL


@pytest.mark.parametrize("widths", [(40, 24, 24), (64, 16)])
def test_td_grouped_matmul_forward_bitwise_and_gradients(widths):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 4, 32)).astype(np.float32)
    ws = [(rng.standard_normal((32, n)) * 32 ** -0.5).astype(np.float32)
          for n in widths]
    jc = JLayer(enabled=True, backend="jnp")
    tc = TLayer(enabled=True)

    def jfn(a, *b):
        return jnp.concatenate(jlayers.td_grouped_matmul(a, b, jc), -1)

    def tfn(a, *b):
        return torch.cat(tlayers.td_grouped_matmul(a, b, tc), -1)
    yj = jfn(jnp.asarray(x), *map(jnp.asarray, ws))
    _, gj = _loss_grads_jax(jfn, jnp.asarray(x), *map(jnp.asarray, ws))
    yt, gt = _loss_grads_torch(tfn, x, *ws)
    assert np.array_equal(yt.numpy(), np.asarray(yj))
    for a, b in zip(gt, gj):
        assert _rel(a.numpy(), b) <= GRAD_RTOL


@pytest.mark.parametrize("windows", [None, (0.02, 0.03, 0.025)])
def test_td_expert_matmul_forward_bitwise_and_gradients(windows):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 6, 32)).astype(np.float32)
    x[1, 4:] = 0.0                         # capacity padding rows
    w = (rng.standard_normal((3, 32, 16)) * 32 ** -0.5).astype(np.float32)
    jc = JLayer(enabled=True, backend="jnp", out_scale=windows)
    tc = TLayer(enabled=True, out_scale=windows)
    yj = jlayers.td_expert_matmul(jnp.asarray(x), jnp.asarray(w), jc)
    _, gj = _loss_grads_jax(lambda a, b: jlayers.td_expert_matmul(a, b, jc),
                            jnp.asarray(x), jnp.asarray(w))
    yt, gt = _loss_grads_torch(
        lambda a, b: tlayers.td_expert_matmul(a, b, tc), x, w)
    assert np.array_equal(yt.numpy(), np.asarray(yj))
    for a, b in zip(gt, gj):
        assert _rel(a.numpy(), b) <= GRAD_RTOL


# ---------------------------------------------------------------------------
# Noisy codes through the layers
# ---------------------------------------------------------------------------
def _noisy_exact(x, w, draws, cfg):
    """The exact (float64) readout inputs of a noisy td_matmul: (acc64,
    absacc64, x_scale, w_scale, gain, s64, s_rel), from the port's codes."""
    qx = tquant.encode_input(torch.from_numpy(x).reshape(-1, x.shape[-1]),
                             cfg.bits)
    qw = tquant.program_noise(tquant.program_weights(
        torch.from_numpy(w), cfg.weight_bits), cfg.spec, draws)
    xc, wc = qx.codes.double(), qw.codes.double()
    acc64, absacc64 = xc @ wc, xc.abs() @ wc.abs()
    k = w.shape[0]
    gain = float(np.float32(1.0 / (qx.levels * qw.levels * 2.0 * k)))
    xs = qx.scale.reshape(1, -1)
    ws = (qw.scale.reshape(-1) * np.float32(2.0 * k)).reshape(1, -1)
    s64 = torch.clamp_min(torch.amax(acc64.abs()) * gain, 1e-9)
    s_rel = tk.F32X3_RTOL * float(torch.amax(absacc64)) * gain / s64
    return acc64[None], absacc64[None], xs, ws, gain, s64, s_rel


def test_noisy_td_matmul_within_the_float_bound_flips_only_at_ties():
    """Fed the reference's draws, the port's and the JAX package's noisy
    outputs each lie on the exact readout's level or, where the exact value
    is within float32 rounding of a half-integer, its neighbour
    (``tdvmm.check_readout``), and nowhere else."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((16, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 80)) * 96 ** -0.5).astype(np.float32)
    key = jax.random.PRNGKey(9)
    draws = _ref_draws(key, w.shape)
    jc = JLayer(enabled=True, backend="jnp", noise=True)
    tc = TLayer(enabled=True, noise=True)
    yj = np.asarray(jlayers.td_matmul(jnp.asarray(x), jnp.asarray(w), jc,
                                      key))
    yt = tlayers.td_matmul(torch.from_numpy(x), torch.from_numpy(w), tc,
                           draws)
    exact = _noisy_exact(x, w, draws, tc)
    for y in (yt, torch.from_numpy(yj)):
        flips, bad = tk.check_readout(y[None], *exact[:2], exact[2],
                                      exact[3], exact[4], 6, exact[5],
                                      exact[6])
        assert bad == 0 and flips <= 2
    # a level moved where the exact value is no tie fails the gate
    step = (exact[2].double()[..., :, None] * exact[3].double()[..., None, :]
            * exact[5] / 63.0)
    c = (exact[0] * exact[4] / exact[5]).clamp(-1, 1) * 63
    far = ((c - c.round()).abs() < 0.25)[0]
    i, j = [int(v[0]) for v in torch.nonzero(far, as_tuple=True)]
    moved = yt.clone().double()
    moved[i, j] += step[0, i, j]
    assert tk.check_readout(moved[None], *exact[:2], exact[2], exact[3],
                            exact[4], 6, exact[5], exact[6])[1] == 1


def test_noisy_gradients_match_reference():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 4, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 40)) * 48 ** -0.5).astype(np.float32)
    key = jax.random.PRNGKey(4)
    draws = _ref_draws(key, w.shape)
    # a fixed window: outputs away from ties leave the gradient unmoved
    jc = JLayer(enabled=True, backend="jnp", noise=True, io_quantize=False)
    tc = TLayer(enabled=True, noise=True, io_quantize=False)
    _, gj = _loss_grads_jax(lambda a, b: jlayers.td_matmul(a, b, jc, key),
                            jnp.asarray(x), jnp.asarray(w))
    _, gt = _loss_grads_torch(lambda a, b: tlayers.td_matmul(a, b, tc, draws),
                              x, w)
    for a, b in zip(gt, gj):
        assert _rel(a.numpy(), b) <= GRAD_RTOL


def test_noisy_grouped_and_calibrate_out_scale_match_reference():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((6, 32)).astype(np.float32)
    ws = [(rng.standard_normal((32, n)) * 32 ** -0.5).astype(np.float32)
          for n in (40, 24)]
    key = jax.random.PRNGKey(5)
    # the noise perturbs the concat bank, each member in its 128-lane span
    draws = _ref_draws(key, (32, 256))
    jc = JLayer(enabled=True, backend="jnp", noise=True, io_quantize=False)
    tc = TLayer(enabled=True, noise=True, io_quantize=False)
    yj = jlayers.td_grouped_matmul(jnp.asarray(x),
                                   tuple(map(jnp.asarray, ws)), jc, key)
    yt = tlayers.td_grouped_matmul(torch.from_numpy(x),
                                   tuple(map(torch.from_numpy, ws)), tc, draws)
    for a, b in zip(yt, yj):
        assert _rel(a.numpy(), b) <= 1e-6
    jc1 = JLayer(enabled=True, backend="jnp", noise=True)
    tc1 = TLayer(enabled=True, noise=True)
    sj = jlayers.calibrate_out_scale(jnp.asarray(x), jnp.asarray(ws[0]), jc1,
                                     key)
    st = tlayers.calibrate_out_scale(torch.from_numpy(x),
                                     torch.from_numpy(ws[0]), tc1,
                                     _ref_draws(key, ws[0].shape))
    assert abs(st - sj) <= 1e-6 * abs(sj)


def test_noisy_sites_take_the_3xtf32_storage_and_no_max_code(monkeypatch):
    seen = []
    real = tops.tdvmm_matmul

    def spy(*args, **kw):
        seen.append((kw.get("code_dtype"), kw.get("max_code")))
        return real(*args, **kw)
    monkeypatch.setattr(tops, "tdvmm_matmul", spy)
    x, w = torch.randn(3, 16), torch.randn(16, 8)
    tlayers.td_matmul(x, w, TLayer(enabled=True, noise=True), key=3)
    tlayers.td_matmul(x, w, TLayer(enabled=True))
    assert seen == [("f32x3", None), ("int8", 63)]
    assert tk.check_code_width("f32x3", None) == "f32x3"
    assert {"raw_f32x3", "fused_f32x3", "calibrated_f32x3"} <= set(
        tk.LAUNCHES)


# ---------------------------------------------------------------------------
# The card's 3xTF32 arithmetic, emulated (B1/B2 storage "f32x3")
# ---------------------------------------------------------------------------
def _tf32(v):
    """``cvt.rna.tf32.f32`` on finite values: the low 13 bits cleared after
    adding half of them (the kernel's two integer operations)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mma_add(d, x):
    """d + x as the tensor cores accumulate: toward zero, not to nearest."""
    exact = d.double() + x.double()
    r = exact.float()
    over = r.double().abs() > exact.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def emulate_f32x3(x, w, passes=3, stage=32):
    """(M, K) x (K, N) float32 codes as the 3xTF32 tile sums them: each
    32-code K stage from zero, k8 block by k8 block, lo.hi + hi.lo + hi.hi
    (``passes`` 1: hi.hi only) into a truncating accumulator, then added to
    the total with one float32 add."""
    x_hi, w_hi = _tf32(x), _tf32(w)
    x_lo, w_lo = _tf32(x - x_hi), _tf32(w - w_hi)
    pairs = ((x_lo, w_hi), (x_hi, w_lo), (x_hi, w_hi))[3 - passes:]
    k = x.shape[1]
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32)
    for s0 in range(0, k, stage):
        part = torch.zeros_like(acc)
        for k0 in range(s0, min(s0 + stage, k), 8):
            ks = slice(k0, k0 + 8)
            for a, b in pairs:
                part = _mma_add(part, a[:, ks].double() @ b[ks].double())
        acc = acc + part
    return acc


def _noisy_codes(rows, k, n, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(-63, 64, (rows, k), generator=gen).float()
    w = torch.randint(-63, 64, (k, n), generator=gen).float()
    w = tquant.program_noise(tquant.QuantizedTensor(w, torch.ones(()), 6),
                             TSpec(), seed).codes
    return x, w


# qwen1.5-0.5b's QAT sites at 2048 rows: ffn.in, ffn.out, the grouped
# q/k/v launch; 24 rows of each (rows are independent in the product)
QAT_SHAPES = [(1024, 2816), (2816, 1024), (1024, 3072)]


@pytest.mark.parametrize("k,n", QAT_SHAPES)
def test_f32x3_emulation_within_the_gate_at_qwen_qat_shapes(k, n):
    x, w = _noisy_codes(24, k, n, seed=k + n)
    exact = x.double() @ w.double()
    absacc = x.abs().double() @ w.abs().double()
    got = emulate_f32x3(x, w)
    rel = float(((got.double() - exact).abs() / absacc).max())
    # the emulated kernel sits far inside the gate (measured <= 5.7e-8
    # here, against 2^-20 = 9.5e-7), and so does the plain float32 matmul
    # (<= 9.2e-8)
    assert rel <= tk.F32X3_RTOL / 4
    plain = float(((torch.matmul(x, w).double() - exact).abs()
                   / absacc).max())
    assert plain <= tk.F32X3_RTOL


def test_f32x3_gate_refuses_one_tf32_product():
    """The gate tells 3xTF32 from a single TF32 product (2.8e-5 of
    sum|x||w| here, ~30x the gate)."""
    x, w = _noisy_codes(8, 1024, 256, seed=1)
    exact = x.double() @ w.double()
    absacc = x.abs().double() @ w.abs().double()
    got = emulate_f32x3(x, w, passes=1)
    assert float(((got.double() - exact).abs() / absacc).max()) \
        > 10 * tk.F32X3_RTOL


@pytest.mark.parametrize("lim_x,lim_w", [(511, 15), (2047, 7)])
def test_f32x3_emulation_is_exact_on_p9_p11_integer_codes(lim_x, lim_w):
    gen = torch.Generator().manual_seed(lim_x)
    x = torch.randint(-lim_x, lim_x + 1, (16, 1024), generator=gen).float()
    w = torch.randint(-lim_w, lim_w + 1, (1024, 96), generator=gen).float()
    assert torch.equal(_tf32(x), x) and torch.equal(_tf32(w), w)
    assert torch.equal(emulate_f32x3(x, w), torch.matmul(x, w))
