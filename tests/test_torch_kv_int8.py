"""The int8 KV cache in the port (``attention.set_kv_cache_int8``): the
quantizer's codes and scales bitwise the JAX package's, the dense cache's decode against the
full-precision forward and the reference's int8 decode, the sliding-window
ring, the engine's page pools under page reuse, and the static path of the
hybrid zamba2 — the same inputs made from a numpy seed on both sides."""
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
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro_torch import convert
from repro_torch.configs import TDVMMPlan as TPlan
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke as tsmoke
from repro_torch.configs import tdvmm_rule as trule
from repro_torch.core.calibration import CalibrationState
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.runtime.engine import Engine, EngineConfig, Request
from repro_torch.runtime.paged_cache import pages_for

# The JAX package's own bound on the int8 decode's last logits against the
# full-precision forward (tests/test_models.py::
# test_int8_kv_cache_decode_close_to_full).
FULL_ATOL = 0.15
# Port against the reference's int8 path, relative to max|logit| (and the
# cache's scales relative to their max): the quantizer is bitwise, the keys
# and values it is fed come from float32 sums in other orders (measured:
# codes equal, scales within 5.7e-7, logits within 6.4e-7).
LOGIT_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.fixture
def int8_kv():
    """The int8 switch on in both packages for one test."""
    jattn.set_kv_cache_int8(True)
    tattn.set_kv_cache_int8(True)
    yield
    jattn.set_kv_cache_int8(False)
    tattn.set_kv_cache_int8(False)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@functools.lru_cache(maxsize=None)
def _model(arch: str):
    jc, tc = jsmoke(jget(arch)), tsmoke(tget(arch))
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jc)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), tc,
                                        "cpu")
    return jc, tc, jparams, tparams


def test_kv_quantize_bitwise():
    """Codes, scales and the dequantized values equal the reference's bit
    for bit, an all-zero (token, head) row (the 1e-6 floor) and values on
    rounding ties included."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 7, 4, 16)) * 3).astype(np.float32)
    x[0, 3, 1] = 0.0
    x[1, 2, 0] = np.linspace(-127, 127, 16, dtype=np.float32) / 2
    jq, js = jattn._kv_quantize(jnp.asarray(x))
    tq, ts = tattn._kv_quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = jattn._kv_dequantize(jq, js, jnp.float32)
    td = tattn._kv_dequantize(tq, ts, torch.float32)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_int8_decode_close_to_full_and_to_reference(int8_kv):
    """smoke(yi-34b): prefill 11 tokens into an int8 cache, decode the 12th;
    its logits within FULL_ATOL of the full-precision forward's, and within
    LOGIT_RTOL of max|logit| of the reference's int8 decode.  After the
    prefill the cache's codes are the reference's or one step from them
    (keys at a rounding tie), its scales within LOGIT_RTOL."""
    jc, tc, jparams, tparams = _model("yi-34b")
    b, s = 2, 12
    inputs = np.random.default_rng(1).integers(0, tc.vocab_size, (b, s))
    full, _ = tmodel.forward(tparams, {"inputs": torch.from_numpy(inputs)},
                             tc)
    caches = tmodel.init_caches(tc, b, s, "cpu")
    assert caches["seg0"].k.dtype == torch.int8
    assert tuple(caches["seg0"].k_scale.shape) == (tc.n_layers, b, s,
                                                   tc.n_kv_heads)
    _, caches = tmodel.prefill_step(
        tparams, {"inputs": torch.from_numpy(inputs[:, :-1])}, caches, tc)
    jcaches = jmodel.init_caches(jc, b, s)
    _, jcaches = jmodel.prefill_step(
        jparams, {"inputs": jnp.asarray(inputs[:, :-1])}, jcaches, jc)
    for name in ("k", "v"):
        # the keys and values come out of float32 products summed in other
        # orders, so a code may sit on the other side of a rounding tie
        codes = getattr(caches["seg0"], name).numpy().astype(np.int32)
        want = np.asarray(getattr(jcaches["seg0"], name)).astype(np.int32)
        assert np.abs(codes - want).max() <= 1
        assert (codes != want).mean() < 1e-2
        assert _rel(getattr(caches["seg0"], name + "_scale").numpy(),
                    np.asarray(getattr(jcaches["seg0"], name + "_scale"))
                    ) <= LOGIT_RTOL
    dec, _ = tmodel.decode_step(
        tparams, {"inputs": torch.from_numpy(inputs[:, -1:])}, caches, tc)
    jdec, _ = jmodel.decode_step(
        jparams, {"inputs": jnp.asarray(inputs[:, -1:])}, jcaches, jc)
    err = float((full[:, -1] - dec[:, 0]).abs().max())
    assert err < FULL_ATOL, err
    assert _rel(dec.numpy(), np.asarray(jdec)) <= LOGIT_RTOL


def _greedy(step_fns, prompts, n):
    """Greedy tokens and last-position logits of a (prefill, decode) pair."""
    prefill, decode = step_fns
    logits = prefill(prompts)
    rows = [np.asarray(logits[:, -1])]
    toks = [np.argmax(rows[-1], -1)]
    while len(toks) < n:
        logits = decode(toks[-1][:, None])
        rows.append(np.asarray(logits[:, -1]))
        toks.append(np.argmax(rows[-1], -1))
    return np.stack(toks, 1), np.stack(rows, 1)


def _port_steps(tc, tparams, batch, max_len, calib=None):
    state = {"c": tmodel.init_caches(tc, batch, max_len, "cpu")}
    v = tc.vocab_size

    def prefill(p):
        lg, state["c"] = tmodel.prefill_step(
            tparams, {"inputs": torch.from_numpy(p)}, state["c"], tc,
            calib=calib)
        return lg[..., :v].numpy()

    def decode(t):
        lg, state["c"] = tmodel.decode_step(
            tparams, {"inputs": torch.from_numpy(t)}, state["c"], tc,
            calib=calib)
        return lg[..., :v].numpy()
    return prefill, decode


def _ref_steps(jc, jparams, batch, max_len, calib=None):
    state = {"c": jmodel.init_caches(jc, batch, max_len)}
    v = jc.vocab_size

    def prefill(p):
        lg, state["c"] = jmodel.prefill_step(
            jparams, {"inputs": jnp.asarray(p)}, state["c"], jc, calib=calib)
        return np.asarray(lg)[..., :v]

    def decode(t):
        lg, state["c"] = jmodel.decode_step(
            jparams, {"inputs": jnp.asarray(t)}, state["c"], jc, calib=calib)
        return np.asarray(lg)[..., :v]
    return prefill, decode


def test_int8_sliding_window_ring_matches_reference(int8_kv):
    """smoke(mixtral-8x7b): a 13-token prompt into a ring of 8 slots, codes
    and scales rolled together, then 6 decode steps around the ring: the
    reference's greedy tokens and logits."""
    jc, tc, jparams, tparams = _model("mixtral-8x7b")
    prompts = np.random.default_rng(2).integers(0, tc.vocab_size, (2, 13))
    toks_t, lt = _greedy(_port_steps(tc, tparams, 2, 20), prompts, 7)
    toks_j, lj = _greedy(_ref_steps(jc, jparams, 2, 20), prompts, 7)
    np.testing.assert_array_equal(toks_t, toks_j)
    assert _rel(lt, lj) <= LOGIT_RTOL


@functools.lru_cache(maxsize=None)
def _served():
    """smoke(qwen1.5-0.5b) with ffn.* TD-VMM sites and the reference's
    windows (the port's engine test setup)."""
    jc = jsmoke(jget("qwen1.5-0.5b")).replace(tdvmm_plan=JPlan((
        jrule("ffn.*", enabled=True, backend="jnp"),)))
    tc = tsmoke(tget("qwen1.5-0.5b")).replace(tdvmm_plan=TPlan((
        trule("ffn.*", enabled=True),)))
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jc)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), tc,
                                        "cpu")
    batch = {"inputs": jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0,
                                          jc.vocab_size)}
    jcal = jmodel.calibrate(jparams, batch, jc, max_len=48)
    return tc, tparams, CalibrationState(windows={
        s: torch.from_numpy(np.array(v, np.float32))
        for s, v in jcal.windows.items()})


@pytest.mark.parametrize("int8", [False, True])
def test_page_reuse_no_stale_scale_bleed(int8):
    """A request reallocating a finished request's pages sees no trace of
    the old codes or scales (stale positions are masked out; every written
    position carries its own fresh scale): each stream equals the request
    served alone by an engine of its own (the int8 contract is engine
    against solo engine)."""
    tc, tparams, tcal = _served()
    reqs = [Request(0, tuple(range(1, 11)), max_new_tokens=5,
                    arrival_step=0),
            Request(1, tuple(range(40, 49)), max_new_tokens=5,
                    arrival_step=1)]
    ecfg = EngineConfig(slots=2, page_size=4, num_pages=4, chunk=8)
    assert pages_for(15, 4) == 4          # A fills the whole pool
    tattn.set_kv_cache_int8(int8)
    try:
        eng = Engine(tc, tparams, ecfg, calib=tcal, device="cpu")
        rep = eng.run(reqs)
        pool = eng._st.caches["seg0"]
        assert (pool.k.dtype == torch.int8) == int8
        assert (pool.k_scale is not None) == int8
        head = tc.resolved_head_dim
        per_head = head + 4 if int8 else 4 * head
        assert rep.page_bytes == (2 * tc.n_layers * 4 * tc.n_kv_heads
                                  * per_head)
        solo_cfg = EngineConfig(slots=1, page_size=4, num_pages=8, chunk=8)
        for req, rec in zip(reqs, rep.requests):
            assert rec["finish_reason"] == "max_tokens"
            solo = Engine(tc, tparams, solo_cfg, calib=tcal,
                          device="cpu").run(
                [Request(req.rid, req.prompt, req.max_new_tokens, 0)])
            assert rec["tokens"] == solo.requests[0]["tokens"], \
                f"int8={int8}: stale page state bled into request {req.rid}"
        assert rep.nan_logit_steps == 0
    finally:
        tattn.set_kv_cache_int8(False)


def test_zamba2_static_serve_int8(int8_kv):
    """The hybrid zamba2 through ``serve_static`` with int8 KV (the mirror
    of the JAX package's tests/test_serve.py::test_serve_ssm_int8_kv): the
    shared block's per-group caches hold int8 codes, and the streams are
    the reference's int8 greedy streams."""
    jc, tc, jparams, tparams = _model("zamba2-2.7b")
    prompts = np.random.default_rng(3).integers(0, tc.vocab_size, (2, 8))
    out = serve.serve_static(tc, 2, 8, 4, device="cpu", params=tparams,
                             prompts=torch.from_numpy(prompts))
    assert tuple(out["tokens"].shape) == (2, 4) and out["nan_steps"] == 0
    caches = tmodel.init_caches(tc, 2, 12, "cpu")
    assert caches["shared_attn"].k.dtype == torch.int8
    toks_j, _ = _greedy(_ref_steps(jc, jparams, 2, 12), prompts, 4)
    np.testing.assert_array_equal(out["tokens"].numpy(), toks_j)


def test_zamba2_int8_under_tdvmm_plan_matches_reference(int8_kv):
    """The int8 cache combined with 6-bit readouts: smoke(zamba2-2.7b) with
    TD-VMM at ``ssm.*``, ``ffn.*`` and ``hybrid.fuse`` and the reference's
    windows pinned on both sides (calibrated with int8 KV on), a 13-token
    prompt and 6 greedy tokens: the reference's int8 tokens, logits within
    LOGIT_RTOL of max|logit|.  A fault in the int8 path that only shows
    where the readouts turn the cache's rounding into whole levels moves a
    code here."""
    sites = ("ssm.*", "ffn.*", "hybrid.fuse")
    jc = jsmoke(jget("zamba2-2.7b")).replace(tdvmm_plan=JPlan(tuple(
        jrule(p, enabled=True, backend="jnp") for p in sites)))
    tc = tsmoke(tget("zamba2-2.7b")).replace(tdvmm_plan=TPlan(tuple(
        trule(p, enabled=True) for p in sites)))
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jc)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), tc,
                                        "cpu")
    rng = np.random.default_rng(4)
    calib_tokens = rng.integers(0, jc.vocab_size, (2, 13))
    jcal = jmodel.calibrate(jparams, {"inputs": jnp.asarray(calib_tokens)},
                            jc)
    tcal = CalibrationState(windows={
        s: torch.from_numpy(np.array(v, np.float32))
        for s, v in jcal.windows.items()})
    assert set(jcal.windows) == {"ssm.in_proj", "ssm.out", "ffn.in",
                                 "ffn.out", "hybrid.fuse"}
    prompts = rng.integers(0, jc.vocab_size, (2, 13))
    toks_t, lt = _greedy(_port_steps(tc, tparams, 2, 19, tcal), prompts, 6)
    toks_j, lj = _greedy(_ref_steps(jc, jparams, 2, 19, jcal), prompts, 6)
    np.testing.assert_array_equal(toks_t, toks_j)
    assert _rel(lt, lj) <= LOGIT_RTOL


def test_cli_kv_int8_static_and_engine(capsys):
    """``launch.serve --kv-int8`` on the CPU, through the static path
    (zamba2) and the engine (qwen); the switch is off again after each
    run."""
    serve.main(["--arch", "zamba2-2.7b", "--static", "--smoke", "--kv-int8",
                "--batch", "2", "--prompt-len", "8", "--gen", "3",
                "--device", "cpu"])
    assert not tattn.KV_CACHE_INT8
    serve.main(["--arch", "qwen1.5-0.5b", "--smoke", "--kv-int8",
                "--requests", "3", "--prompt-len", "8", "--gen", "3",
                "--device", "cpu"])
    assert not tattn.KV_CACHE_INT8
    out = capsys.readouterr().out
    assert "[serve] zamba2-2.7b batch=2" in out and "3 requests" in out
