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
from repro.models import model as jmodel
from repro_torch import convert
from repro_torch.configs import TDVMMLayerConfig as TLayer
from repro_torch.configs import TDVMMPlan as TPlan
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke as tsmoke
from repro_torch.configs import tdvmm_rule as trule
from repro_torch.core import calibration as tcal
from repro_torch.core import layers as tlayers
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
