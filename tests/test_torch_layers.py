"""td_matmul and the calibration capture: bitwise the JAX package's for the
same inputs, weights and site config."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TDVMMLayerConfig as JLayer
from repro.configs import TDVMMPlan as JPlan
from repro.configs import get_config as jget
from repro.configs import smoke as jsmoke
from repro.configs import tdvmm_rule as jrule
from repro.core import calibration as jcal
from repro.core import layers as jlayers
from repro.core import quant as jquant
from repro.models import model as jmodel
from repro_torch import convert
from repro_torch.configs import TDVMMLayerConfig as TLayer
from repro_torch.configs import TDVMMPlan as TPlan
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke as tsmoke
from repro_torch.configs import tdvmm_rule as trule
from repro_torch.core import calibration as tcal
from repro_torch.core import layers as tlayers
from repro_torch.core import quant as tquant
from repro_torch.models import model as tmodel


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


SITE_CFGS = {
    "data_calibrated": dict(enabled=True),
    "fixed_window": dict(enabled=True, out_scale=0.02),
    "raw_half_window": dict(enabled=True, output_calibration=False),
    "no_readout": dict(enabled=True, io_quantize=False),
    "p4_per_tensor": dict(enabled=True, bits=4, weight_bits=5,
                          per_channel=False),
    "digital": dict(enabled=False),
}


def _xw(shape, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape + (k,)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    return x, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("site", sorted(SITE_CFGS))
def test_td_matmul_bitwise(site, dtype):
    kw = dict(SITE_CFGS[site], site="ffn.in")
    x, w = _xw((2, 5), 130, 96)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    yj = jlayers.td_matmul(jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd),
                           JLayer(backend="jnp", **kw))
    yj = np.asarray(yj.astype(jnp.float32))
    for backend in ("auto", "jnp"):
        yt = tlayers.td_matmul(torch.from_numpy(x).to(td),
                               torch.from_numpy(w).to(td),
                               TLayer(backend=backend, **kw))
        assert yt.dtype == td
        if kw["enabled"]:
            np.testing.assert_array_equal(yt.float().numpy(), yj)
        else:        # a digital site is a plain float matmul on both sides
            np.testing.assert_allclose(yt.float().numpy(), yj, rtol=2e-2,
                                       atol=2e-2)


def test_runtime_window_equals_static_window():
    x, w = _xw((7,), 64, 48, seed=3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    cfg = TLayer(enabled=True, site="ffn.out")
    s = tlayers.calibrate_out_scale(xt, wt, cfg)
    assert s == jlayers.calibrate_out_scale(jnp.asarray(x), jnp.asarray(w),
                                            JLayer(enabled=True, backend="jnp"))
    static = tlayers.td_matmul(xt, wt, cfg.replace(out_scale=s))
    with tcal.runtime_windows({"ffn.out": torch.tensor(s, dtype=torch.float32)}):
        runtime = tlayers.td_matmul(xt, wt, cfg)
    data = tlayers.td_matmul(xt, wt, cfg)
    np.testing.assert_array_equal(static.numpy(), runtime.numpy())
    # the captured window IS the per-call data-calibrated window
    np.testing.assert_array_equal(static.numpy(), data.numpy())


@pytest.mark.parametrize("chain", [False, True])
def test_calibration_windows_match_reference(chain):
    rules_j = [jrule("ffn.*", enabled=True, backend="jnp")]
    rules_t = [trule("ffn.*", enabled=True)]
    if chain:
        rules_j.append(jrule("ffn.in", chain=True))
        rules_t.append(trule("ffn.in", chain=True))
    jc = jsmoke(jget("qwen1.5-0.5b")).replace(tdvmm_plan=JPlan(tuple(rules_j)))
    tc = tsmoke(tget("qwen1.5-0.5b")).replace(tdvmm_plan=TPlan(tuple(rules_t)))
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jc)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), tc,
                                        "cpu")
    tokens = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 12))
    calib_j = jmodel.calibrate(jparams, {"inputs": jnp.asarray(tokens)}, jc)
    calib_t = tmodel.calibrate(tparams, {"inputs": tokens}, tc, device="cpu")
    assert calib_t.sites() == calib_j.sites()
    assert calib_t.sites() == (("ffn.out",) if chain else ("ffn.in", "ffn.out"))
    for site in calib_j.sites():
        np.testing.assert_array_equal(calib_t.windows[site].numpy(),
                                      np.asarray(calib_j.windows[site]))
    # applying the state pins the same out_scale on both sides
    tp, jp = tcal.apply_calibration(tc, calib_t), jcal.apply_calibration(jc, calib_j)
    for site in ("ffn.in", "ffn.out"):
        assert tp.site_tdvmm(site).out_scale == jp.site_tdvmm(site).out_scale


# ---------------------------------------------------------------------------
# Grouped sites: one encode, one ragged concat launch
# ---------------------------------------------------------------------------
RAGGED = (40, 40, 16, 16, 4)            # ssm.in_proj's five members, small


def _members(k, widths, seed=4):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
            for n in widths]


def test_concat_group_bitwise():
    ws = _members(24, RAGGED)
    spans = (128,) * len(RAGGED)
    qt = tquant.concat_group([tquant.program_weights(torch.from_numpy(w), 6)
                              for w in ws], spans)
    qj = jquant.concat_group([jquant.program_weights(jnp.asarray(w), 6)
                              for w in ws], spans)
    assert qt.bits == qj.bits and qt.codes.dtype == torch.int8
    np.testing.assert_array_equal(qt.codes.numpy(), np.asarray(qj.codes))
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(qj.scale))
    assert float(qt.scale[0, 40:128].min()) == 1.0       # pad columns
    with pytest.raises(ValueError, match="exceed"):
        tquant.concat_group([tquant.program_weights(torch.from_numpy(ws[0]),
                                                    6)], (32,))


def _group_windows(x, ws, kw):
    """The (G,) windows the reference captures for the grouped site."""
    with jcal.collect() as got:
        jlayers.td_grouped_matmul(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                                  JLayer(backend="jnp", **kw))
    return np.asarray(got[kw["site"]], np.float32)


GROUP_CFGS = {
    "data_calibrated": dict(enabled=True),
    "member_windows": dict(enabled=True),      # a (G,) tuple out_scale
    "runtime_windows": dict(enabled=True),     # the (G,) window tensor
    "scalar_window": dict(enabled=True, out_scale=0.02),
    "no_readout": dict(enabled=True, io_quantize=False),
    "digital": dict(enabled=False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("site", sorted(GROUP_CFGS))
def test_td_grouped_matmul_bitwise(site, dtype):
    kw = dict(GROUP_CFGS[site], site="ssm.in_proj")
    x, _ = _xw((2, 3), 24, 8, seed=5)
    ws = _members(24, RAGGED)
    if site in ("member_windows", "runtime_windows"):
        win = _group_windows(x, ws, kw) * np.float32(0.8)
    if site == "member_windows":
        kw["out_scale"] = tuple(float(v) for v in win)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    with jcal.runtime_windows({"ssm.in_proj": jnp.asarray(win)}
                              if site == "runtime_windows" else None):
        yj = jlayers.td_grouped_matmul(jnp.asarray(x).astype(jd),
                                       [jnp.asarray(w).astype(jd) for w in ws],
                                       JLayer(backend="jnp", **kw))
    for backend in ("auto", "jnp"):
        cfg = TLayer(backend=backend, **kw)
        args = (torch.from_numpy(x).to(td),
                [torch.from_numpy(w).to(td) for w in ws], cfg)
        if site == "runtime_windows":
            with tcal.runtime_windows({"ssm.in_proj": torch.from_numpy(win)}):
                yt = tlayers.td_grouped_matmul(*args)
        else:
            yt = tlayers.td_grouped_matmul(*args)
        assert len(yt) == len(RAGGED)
        for a, b, n in zip(yt, yj, RAGGED):
            assert a.dtype == td and tuple(a.shape) == (2, 3, n)
            b = np.asarray(b.astype(jnp.float32))
            if kw["enabled"]:
                np.testing.assert_array_equal(a.float().numpy(), b)
            else:      # a digital site is a plain float matmul on both sides
                np.testing.assert_allclose(a.float().numpy(), b, rtol=2e-2,
                                           atol=2e-2)


def test_grouped_calibration_windows_bitwise():
    """The captured (G,) window vector equals the reference's, survives
    ``from_collected``/``apply_calibration`` as a (G,) tuple, and serving
    with it pinned is bitwise the per-call data-calibrated launch."""
    kw = dict(enabled=True, site="ssm.in_proj")
    x, _ = _xw((4,), 24, 8, seed=6)
    ws = _members(24, RAGGED, seed=7)
    want = _group_windows(x, ws, kw)
    xt, wt = torch.from_numpy(x), [torch.from_numpy(w) for w in ws]
    with tcal.collect() as got:
        data = tlayers.td_grouped_matmul(xt, wt, TLayer(**kw))
    assert got["ssm.in_proj"].shape == (len(RAGGED),)
    np.testing.assert_array_equal(got["ssm.in_proj"], want)
    state = tcal.CalibrationState.from_collected(got)
    jstate = jcal.CalibrationState.from_collected({"ssm.in_proj": want})
    tc = tsmoke(tget("mamba2-1.3b")).replace(tdvmm_plan=TPlan((
        trule("ssm.*", enabled=True),)))
    jc = jsmoke(jget("mamba2-1.3b")).replace(tdvmm_plan=JPlan((
        jrule("ssm.*", enabled=True, backend="jnp"),)))
    pinned = tcal.apply_calibration(tc, state).site_tdvmm("ssm.in_proj")
    assert pinned.out_scale == jcal.apply_calibration(
        jc, jstate).site_tdvmm("ssm.in_proj").out_scale
    assert isinstance(pinned.out_scale, tuple)
    assert len(pinned.out_scale) == len(RAGGED)
    served = tlayers.td_grouped_matmul(xt, wt, pinned)
    for a, b in zip(served, data):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
