"""The SSM family through the port's static serving path against the JAX
package's, with the same converted weights: ``smoke(mamba2-1.3b)``, with
TD-VMM off and with ``ssm.*`` on (the reference's windows pinned on both
sides).  Prompts of 13 tokens are not a multiple of the 8-token chunk, so
the scan's padding is on the path."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TDVMMPlan as JPlan
from repro.configs import get_config as jget
from repro.configs import smoke as jsmoke
from repro.configs import tdvmm_rule as jrule
from repro.models import model as jmodel
from repro_torch import convert
from repro_torch.configs import TDVMMPlan as TPlan
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke as tsmoke
from repro_torch.configs import tdvmm_rule as trule
from repro_torch.core.calibration import CalibrationState
from repro_torch.launch import serve
from repro_torch.models import model as tmodel
from repro_torch.runtime.engine import Engine, EngineConfig

ARCH = "mamba2-1.3b"
# Logits relative to max|logit|, TD-VMM off or ssm.* on with the windows
# pinned: measured <= 6.9e-7 (off) and <= 2.5e-7 (ssm.*) over six prompt
# seeds (the scan, the conv and the norms sum in other orders than XLA; the
# TD-VMM codes of both sites came out equal).  A moved code (one readout
# level, up to ~1.6e-2 of a site's output) fails this bound.
LOGIT_RTOL = 1e-5
# The port's own calibration windows against the reference's: a site
# downstream of a scan sees the scan's float rounding, so the windows are
# not bitwise by contract; they came out equal on this batch.
WINDOW_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


@functools.lru_cache(maxsize=None)
def _setup(plan: str):
    """(jax cfg, port cfg, jax params, port params, jax calib, port calib,
    calibration tokens)."""
    jc, tc = jsmoke(jget(ARCH)), tsmoke(tget(ARCH))
    if plan == "ssm":
        jc = jc.replace(tdvmm_plan=JPlan((
            jrule("ssm.*", enabled=True, backend="jnp"),)))
        tc = tc.replace(tdvmm_plan=TPlan((trule("ssm.*", enabled=True),)))
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jc)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), tc,
                                        "cpu")
    tokens = np.random.default_rng(7).integers(0, jc.vocab_size, (2, 13))
    jcal = tcal = None
    if plan == "ssm":
        jcal = jmodel.calibrate(jparams, {"inputs": jnp.asarray(tokens)}, jc)
        tcal = CalibrationState(windows={
            s: torch.from_numpy(np.array(v, np.float32))
            for s, v in jcal.windows.items()})
    return jc, tc, jparams, tparams, jcal, tcal, tokens


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _greedy_j(jc, jparams, jcal, prompts, n):
    caches = jmodel.init_caches(jc, prompts.shape[0], prompts.shape[1] + n)
    pre = jax.jit(lambda p, b, c: jmodel.prefill_step(p, b, c, jc, calib=jcal))
    dec = jax.jit(lambda p, b, c: jmodel.decode_step(p, b, c, jc, calib=jcal))
    logits, caches = pre(jparams, {"inputs": jnp.asarray(prompts)}, caches)
    rows = [np.asarray(logits[:, -1])]
    toks = [np.argmax(rows[-1][:, :jc.vocab_size], -1)]
    while len(toks) < n:
        logits, caches = dec(jparams, {"inputs": jnp.asarray(toks[-1][:, None])},
                             caches)
        rows.append(np.asarray(logits[:, -1]))
        toks.append(np.argmax(rows[-1][:, :jc.vocab_size], -1))
    return np.stack(toks, 1), np.stack(rows, 1)


def _greedy_t(tc, tparams, tcal, prompts, n):
    caches = tmodel.init_caches(tc, prompts.shape[0], prompts.shape[1] + n,
                                "cpu")
    logits, caches = tmodel.prefill_step(
        tparams, {"inputs": torch.from_numpy(prompts)}, caches, tc,
        calib=tcal)
    rows = [logits[:, -1].numpy()]
    toks = [np.argmax(rows[-1][:, :tc.vocab_size], -1)]
    while len(toks) < n:
        logits, caches = tmodel.decode_step(
            tparams, {"inputs": torch.from_numpy(toks[-1][:, None])}, caches,
            tc, calib=tcal)
        rows.append(logits[:, -1].numpy())
        toks.append(np.argmax(rows[-1][:, :tc.vocab_size], -1))
    return np.stack(toks, 1), np.stack(rows, 1)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("plan", ["off", "ssm"])
def test_prefill_and_decode_match_reference(plan, seed):
    jc, tc, jparams, tparams, jcal, tcal, _ = _setup(plan)
    prompts = np.random.default_rng(100 + seed).integers(
        0, jc.vocab_size, (2, 13))
    toks_j, lj = _greedy_j(jc, jparams, jcal, prompts, 6)
    toks_t, lt = _greedy_t(tc, tparams, tcal, prompts, 6)
    np.testing.assert_array_equal(toks_t, toks_j)
    assert _rel(lt, lj) <= LOGIT_RTOL


def test_calibration_windows_match_reference():
    jc, tc, jparams, tparams, jcal, _, tokens = _setup("ssm")
    calib = tmodel.calibrate(tparams, {"inputs": tokens}, tc, device="cpu")
    assert calib.sites() == jcal.sites() == ("ssm.in_proj", "ssm.out")
    assert tuple(calib.windows["ssm.in_proj"].shape) == (5,)
    assert tuple(calib.windows["ssm.out"].shape) == ()
    for site in jcal.sites():
        assert _rel(calib.windows[site].numpy(),
                    np.asarray(jcal.windows[site])) <= WINDOW_RTOL


def test_static_serve_streams_match_reference():
    """``launch.serve.serve_static`` on the CPU: the reference's greedy
    streams, and a batch served in reverse order gives the reversed
    streams."""
    jc, tc, jparams, tparams, jcal, tcal, _ = _setup("ssm")
    prompts = np.random.default_rng(9).integers(0, jc.vocab_size, (3, 13))
    toks_j, _ = _greedy_j(jc, jparams, jcal, prompts, 5)
    out = serve.serve_static(tc, 3, 13, 5, calib=tcal, device="cpu",
                             params=tparams, prompts=torch.from_numpy(prompts))
    assert out["nan_steps"] == 0
    np.testing.assert_array_equal(out["tokens"].numpy(), toks_j)
    rev = serve.serve_static(tc, 3, 13, 5, calib=tcal, device="cpu",
                             params=tparams,
                             prompts=torch.from_numpy(prompts[::-1].copy()))
    np.testing.assert_array_equal(rev["tokens"].numpy(), toks_j[::-1])


def test_ssm_caches_and_paged_refusal():
    tc = tsmoke(tget(ARCH))
    caches = tmodel.init_caches(tc, 3, 32, "cpu")
    c = caches["seg0"]
    assert tuple(c.conv.shape) == (2, 3, 3, 128 + 2 * 16)
    assert tuple(c.state.shape) == (2, 3, 8, 16, 16)
    assert c.state.dtype == torch.float32 and tuple(c.pos.shape) == (2, 3)
    with pytest.raises(NotImplementedError, match="static path"):
        tmodel.init_paged_caches(tc, 8, 4, "cpu")
    params = tmodel.init_params(0, tc, device="cpu")
    assert params["blocks"]["seg0"][0]["ssm"]["A_log"].dtype == torch.float32
    with pytest.raises(NotImplementedError,
                       match="attention families, not 'ssm'.*static"):
        Engine(tc, params, EngineConfig(), device="cpu")
    # the hybrid family is served by the static path only, as in the JAX
    # package: the engine and the page pools refuse it
    hc = tsmoke(tget("zamba2-2.7b"))
    with pytest.raises(NotImplementedError, match="'hybrid'.*static"):
        Engine(hc, tmodel.init_params(0, hc, device="cpu"), EngineConfig(),
               device="cpu")
    with pytest.raises(NotImplementedError, match="'hybrid'.*static path"):
        tmodel.init_paged_caches(hc, 8, 4, "cpu")


@pytest.mark.parametrize("plan", ["off", "ssm"])
def test_apply_train_is_the_prefill_from_a_zero_state(plan):
    """``ssm.apply_train`` shares the projections, conv, gates and output
    with ``apply_prefill``: on the CPU, where both scans are ``ssd_plain``,
    its output is the prefill's from a fresh cache, bitwise, and within
    LOGIT_RTOL of the JAX package's ``apply_train`` (both sides' sites
    data-calibrated)."""
    from repro.models import ssm as jssm
    from repro_torch.models import ssm as tssm
    jc, tc, jparams, tparams, *_ = _setup(plan)
    u = np.random.default_rng(5).standard_normal((2, 13, tc.d_model)).astype(
        np.float32)
    p = tparams["blocks"]["seg0"][0]["ssm"]
    out = tssm.apply_train(p, torch.from_numpy(u), tc)
    cache = tssm.init_cache(tc, 2, torch.float32, "cpu")
    pre, _ = tssm.apply_prefill(p, torch.from_numpy(u), tc, cache)
    assert torch.equal(out, pre)
    want = jssm.apply_train(jax.tree.map(lambda a: a[0],
                                         jparams["blocks"]["seg0"])["ssm"],
                            jnp.asarray(u), jc)
    assert _rel(out.numpy(), want) <= LOGIT_RTOL
