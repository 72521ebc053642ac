"""Model entry points of the port against the JAX package's, with the same
converted weights: logits within float tolerance with TD-VMM off, equal
greedy streams with ``ffn.*`` TD-VMM on (the reference's windows pinned);
the smoke mixtral through the static path under both MoE plans."""
import dataclasses
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
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttransformer

# Logit agreement with TD-VMM on, relative to max|logit|.  Measured on six
# seeds at smoke width: at most 4.8e-7 with ffn.* on, unchained or chained,
# the same as with TD-VMM off (5.7e-7): the codes are bitwise the
# reference's, and only float32 reductions outside the sites (attention and
# norms sum in another order than XLA) differ.  A moved code (one readout
# level, up to ~1.6e-2 of a site's output) fails this bound.
TDVMM_LOGIT_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


PLANS = {
    "off": ((), ()),
    "ffn_unchained": ((("ffn.*", {"enabled": True}),), ()),
    "ffn_chained": ((("ffn.*", {"enabled": True}),),
                    (("ffn.in", {"chain": True}),)),
}


@functools.lru_cache(maxsize=None)
def _setup(plan: str):
    """(jax cfg, port cfg, jax params, port params, jax calib, port calib)."""
    rules = PLANS[plan][0] + PLANS[plan][1]
    jc = jsmoke(jget("qwen1.5-0.5b"))
    tc = tsmoke(tget("qwen1.5-0.5b"))
    if rules:
        jc = jc.replace(tdvmm_plan=JPlan(tuple(
            jrule(p, backend="jnp", **kw) if "enabled" in kw else jrule(p, **kw)
            for p, kw in rules)))
        tc = tc.replace(tdvmm_plan=TPlan(tuple(trule(p, **kw)
                                               for p, kw in rules)))
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jc)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), tc,
                                        "cpu")
    jcal = tcal = None
    if rules:
        tokens = np.random.default_rng(7).integers(0, jc.vocab_size, (2, 16))
        jcal = jmodel.calibrate(jparams, {"inputs": jnp.asarray(tokens)}, jc)
        tcal = CalibrationState(windows={
            s: torch.from_numpy(np.array(v, np.float32))
            for s, v in jcal.windows.items()})
    return jc, tc, jparams, tparams, jcal, tcal


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _greedy_j(jc, jparams, jcal, prompt, n):
    caches = jmodel.init_caches(jc, 1, len(prompt) + n)
    pre = jax.jit(lambda p, b, c: jmodel.prefill_step(p, b, c, jc, calib=jcal))
    dec = jax.jit(lambda p, b, c: jmodel.decode_step(p, b, c, jc, calib=jcal))
    logits, caches = pre(jparams, {"inputs": jnp.asarray([prompt])}, caches)
    out, toks = [np.asarray(logits[0, -1])], [int(jnp.argmax(logits[0, -1]))]
    while len(toks) < n:
        logits, caches = dec(jparams, {"inputs": jnp.asarray([[toks[-1]]])},
                             caches)
        out.append(np.asarray(logits[0, -1]))
        toks.append(int(jnp.argmax(logits[0, -1])))
    return toks, np.stack(out)


def _greedy_t(tc, tparams, tcal, prompt, n):
    caches = tmodel.init_caches(tc, 1, len(prompt) + n, "cpu")
    logits, caches = tmodel.prefill_step(
        tparams, {"inputs": torch.tensor([prompt])}, caches, tc, calib=tcal)
    out, toks = [logits[0, -1].numpy()], [int(torch.argmax(logits[0, -1]))]
    while len(toks) < n:
        logits, caches = tmodel.decode_step(
            tparams, {"inputs": torch.tensor([[toks[-1]]])}, caches, tc,
            calib=tcal)
        out.append(logits[0, -1].numpy())
        toks.append(int(torch.argmax(logits[0, -1])))
    return toks, np.stack(out)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_greedy_streams_match_reference(plan, seed):
    jc, tc, jparams, tparams, jcal, tcal = _setup(plan)
    rng = np.random.default_rng(100 + seed)
    prompt = [int(t) for t in rng.integers(0, jc.vocab_size, 5 + 3 * seed)]
    toks_j, lj = _greedy_j(jc, jparams, jcal, prompt, 8)
    toks_t, lt = _greedy_t(tc, tparams, tcal, prompt, 8)
    assert toks_t == toks_j
    rtol = 1e-5 if plan == "off" else TDVMM_LOGIT_RTOL
    assert _rel(lt, lj) <= rtol


@pytest.mark.parametrize("plan", ["off", "ffn_chained"])
def test_paged_steps_match_reference(plan):
    """prefill_chunk (two chunks) then decode_slots (one active slot of
    two) against the JAX package's paged steps."""
    jc, tc, jparams, tparams, jcal, tcal = _setup(plan)
    jwin = None if jcal is None else jcal.as_arrays()
    twin = None if tcal is None else tcal.as_arrays("cpu")
    jcache = jmodel.init_paged_caches(jc, 8, 4)
    tcache = tmodel.init_paged_caches(tc, 8, 4, "cpu")
    pre_j = jax.jit(lambda p, b, c, w: jmodel.prefill_chunk(p, b, c, jc,
                                                            windows=w))
    prompt = np.random.default_rng(3).integers(0, jc.vocab_size, 11)
    row = np.array([2, 5, 1, 8, 8], np.int32)       # 8 = trash page
    rtol = 1e-5 if plan == "off" else TDVMM_LOGIT_RTOL
    for start in (0, 8):
        n = min(8, len(prompt) - start)
        toks = np.zeros((1, 8), np.int32)
        toks[0, :n] = prompt[start:start + n]
        lj, jcache = pre_j(jparams, {
            "inputs": jnp.asarray(toks), "block_row": jnp.asarray(row),
            "offset": jnp.int32(start), "valid": jnp.int32(n)}, jcache, jwin)
        lt, tcache = tmodel.prefill_chunk(tparams, {
            "inputs": torch.from_numpy(toks), "block_row": torch.from_numpy(row),
            "offset": torch.tensor(start, dtype=torch.int32),
            "valid": torch.tensor(n, dtype=torch.int32)}, tcache, tc,
            windows=twin)
        assert lt.shape == lj.shape == (1, 1, jc.padded_vocab)
        assert _rel(lt.numpy(), lj) <= rtol
    tok = int(np.argmax(np.asarray(lj)[0, 0, :jc.vocab_size]))
    tables = np.stack([row, np.full(5, 8, np.int32)])
    batch = dict(inputs=np.array([[tok], [0]], np.int32), block_tables=tables,
                 pos=np.array([11, 0], np.int32), active=np.array([True, False]))
    lj, _ = jmodel.decode_slots(jparams, {k: jnp.asarray(v) for k, v in
                                          batch.items()}, jcache, jc,
                                windows=jwin)
    lt, _ = tmodel.decode_slots(tparams, {k: torch.from_numpy(v) for k, v in
                                          batch.items()}, tcache, tc,
                                windows=twin)
    assert _rel(lt[0].numpy(), np.asarray(lj)[0]) <= rtol


def test_init_params_structure_and_seed():
    tc = tsmoke(tget("qwen1.5-0.5b"))
    a = tmodel.init_params(0, tc, device="cpu")
    b = tmodel.init_params(0, tc, device="cpu")
    c = tmodel.init_params(1, tc, device="cpu")
    conv = _setup("off")[3]
    flat = lambda p: {k: v for k, v in _flatten(p)}   # noqa: E731
    fa, fb, fc, fconv = flat(a), flat(b), flat(c), flat(conv)
    assert fa.keys() == fconv.keys()
    for k in fa:
        assert fa[k].shape == fconv[k].shape and fa[k].dtype == fconv[k].dtype
        assert torch.equal(fa[k], fb[k])
    assert not torch.equal(fa["embed/table"], fc["embed/table"])


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


# ---------------------------------------------------------------------------
# The MoE family through the static path (smoke mixtral: 4 experts top-2,
# sliding window 8)
# ---------------------------------------------------------------------------
MOE_PLANS = {
    "moe_unchained": (("moe.*", {"enabled": True}),),
    "moe_mixed": (("moe.*", {"enabled": True}),
                  ("moe.expert.in", {"bits": 8, "weight_bits": 4}),
                  ("moe.expert.out", {"bits": 3, "weight_bits": 3})),
}


@functools.lru_cache(maxsize=None)
def _moe_setup(plan: str, first_k_dense: int):
    jc = jsmoke(jget("mixtral-8x7b"))
    tc = tsmoke(tget("mixtral-8x7b"))
    jc = jc.replace(moe=dataclasses.replace(jc.moe,
                                            first_k_dense=first_k_dense))
    tc = tc.replace(moe=dataclasses.replace(tc.moe,
                                            first_k_dense=first_k_dense))
    rules = MOE_PLANS[plan]
    jc = jc.replace(tdvmm_plan=JPlan(tuple(
        jrule(p, backend="jnp", **kw) if "enabled" in kw else jrule(p, **kw)
        for p, kw in rules)))
    tc = tc.replace(tdvmm_plan=TPlan(tuple(trule(p, **kw) for p, kw in rules)))
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jc)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), tc,
                                        "cpu")
    return jc, tc, jparams, tparams


@pytest.mark.parametrize("first_k_dense", [0, 1])
@pytest.mark.parametrize("plan", sorted(MOE_PLANS))
def test_moe_static_path_matches_reference(plan, first_k_dense):
    """Calibration windows bitwise; a 13-token prompt (longer than the
    window of 8: the ring cache rolls) then greedy decode past the window,
    logits within TDVMM_LOGIT_RTOL (measured <= 8.0e-7 over the four cases)
    and equal tokens, batch of 2; and ``serve_static`` gives the same
    streams."""
    from repro_torch.launch import serve
    jc, tc, jparams, tparams = _moe_setup(plan, first_k_dense)
    assert [kind for kind, _ in ttransformer.segments(tc)] == \
        (["attn_ffn"] if first_k_dense else []) + ["attn_moe"]
    prompts = np.random.default_rng(11 + first_k_dense).integers(
        0, jc.vocab_size, (2, 13))
    jcal = jmodel.calibrate(jparams, {"inputs": jnp.asarray(prompts)}, jc)
    tcal = tmodel.calibrate(tparams, {"inputs": torch.from_numpy(prompts)},
                            tc, device="cpu")
    assert tcal.sites() == jcal.sites() == ("moe.expert.in", "moe.expert.out")
    for site in jcal.sites():
        assert tcal.windows[site].shape == (tc.moe.n_experts,)
        np.testing.assert_array_equal(tcal.windows[site].numpy(),
                                      np.asarray(jcal.windows[site]))
    n_new = 6
    jcache = jmodel.init_caches(jc, 2, 13 + n_new)
    tcache = tmodel.init_caches(tc, 2, 13 + n_new, "cpu")
    lj, jcache = jmodel.prefill_step(jparams, {"inputs": jnp.asarray(prompts)},
                                     jcache, jc, calib=jcal)
    lt, tcache = tmodel.prefill_step(tparams,
                                     {"inputs": torch.from_numpy(prompts)},
                                     tcache, tc, calib=tcal)
    worst, toks = _rel(lt.numpy(), lj), []
    for _ in range(n_new - 1):
        tok_j = np.argmax(np.asarray(lj)[:, -1, :jc.vocab_size], -1)
        tok_t = torch.argmax(lt[:, -1, :tc.vocab_size], -1).numpy()
        np.testing.assert_array_equal(tok_t, tok_j)
        toks.append(tok_j)
        lj, jcache = jmodel.decode_step(
            jparams, {"inputs": jnp.asarray(tok_j[:, None])}, jcache, jc,
            calib=jcal)
        lt, tcache = tmodel.decode_step(
            tparams, {"inputs": torch.from_numpy(tok_t[:, None])}, tcache, tc,
            calib=tcal)
        worst = max(worst, _rel(lt.numpy(), lj))
    toks.append(np.argmax(np.asarray(lj)[:, -1, :jc.vocab_size], -1))
    assert worst <= TDVMM_LOGIT_RTOL
    out = serve.serve_static(tc, 2, 13, n_new, calib=tcal, device="cpu",
                             params=tparams, prompts=torch.from_numpy(prompts))
    assert out["nan_steps"] == 0
    np.testing.assert_array_equal(out["tokens"].numpy(), np.stack(toks, 1))
