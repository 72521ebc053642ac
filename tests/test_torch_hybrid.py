"""The hybrid family (zamba2: Mamba-2 groups, each followed by one shared
attention + FFN block fed fuse(concat(x, embed0))) through the port's
static serving path against the JAX package's, with the same converted
weights: ``smoke(zamba2-2.7b)`` (4 layers, a shared block every 2), with
TD-VMM off and with it on at ``ssm.*``, ``ffn.*`` and ``hybrid.fuse``.
Prompts of 13 tokens are not a multiple of the 8-token chunk."""
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
from repro_torch.models import transformer

ARCH = "zamba2-2.7b"
SITES = ("ssm.*", "ffn.*", "hybrid.fuse")
# Logits relative to max|logit| over the run, TD-VMM off or on with the
# reference's windows pinned on both sides: the scan, the conv, attention
# and the norms sum in other orders than XLA (measured <= 1.7e-6 off,
# <= 3.3e-7 on, flash included); a moved TD-VMM code (one readout level,
# ~1e-2 of a site's output) fails it.
LOGIT_RTOL = 1e-5


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
    if plan == "tdvmm":
        jc = jc.replace(tdvmm_plan=JPlan(tuple(
            jrule(s, enabled=True, backend="jnp") for s in SITES)))
        tc = tc.replace(tdvmm_plan=TPlan(tuple(
            trule(s, enabled=True) for s in SITES)))
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jc)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), tc,
                                        "cpu")
    tokens = np.random.default_rng(7).integers(0, jc.vocab_size, (2, 13))
    jcal = tcal = None
    if plan == "tdvmm":
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
@pytest.mark.parametrize("plan", ["off", "tdvmm"])
def test_prefill_and_decode_match_reference(plan, seed):
    jc, tc, jparams, tparams, jcal, tcal, _ = _setup(plan)
    prompts = np.random.default_rng(100 + seed).integers(
        0, jc.vocab_size, (2, 13))
    toks_j, lj = _greedy_j(jc, jparams, jcal, prompts, 6)
    toks_t, lt = _greedy_t(tc, tparams, tcal, prompts, 6)
    np.testing.assert_array_equal(toks_t, toks_j)
    assert _rel(lt, lj) <= LOGIT_RTOL


def test_calibration_windows_match_reference():
    """The port's own calibration pass gives the reference's windows bitwise
    at every site, the shared block's two sites max-merged over its calls."""
    jc, tc, jparams, tparams, jcal, _, tokens = _setup("tdvmm")
    calib = tmodel.calibrate(tparams, {"inputs": tokens}, tc, device="cpu")
    assert set(calib.sites()) == set(jcal.sites()) == {
        "ssm.in_proj", "ssm.out", "ffn.in", "ffn.out", "hybrid.fuse"}
    assert tuple(calib.windows["ssm.in_proj"].shape) == (5,)
    for site in jcal.sites():
        np.testing.assert_array_equal(calib.windows[site].numpy(),
                                      np.asarray(jcal.windows[site]))


@pytest.mark.parametrize("block_skip", [False, True])
def test_prompt_past_the_flash_threshold(monkeypatch, block_skip):
    """With the flash threshold lowered to 8 and 4-token blocks, the shared
    block's 13-token prefill runs flash attention on both sides (padded to
    the block grid), with TD-VMM on."""
    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "FLASH_THRESHOLD", 8)
        monkeypatch.setattr(mod, "FLASH_BLOCK_Q", 4)
        monkeypatch.setattr(mod, "FLASH_BLOCK_KV", 4)
        monkeypatch.setattr(mod, "FLASH_BLOCK_SKIP", block_skip)
    jc, tc, jparams, tparams, jcal, tcal, _ = _setup("tdvmm")
    prompts = np.random.default_rng(5).integers(0, jc.vocab_size, (2, 13))
    toks_j, lj = _greedy_j(jc, jparams, jcal, prompts, 5)
    toks_t, lt = _greedy_t(tc, tparams, tcal, prompts, 5)
    np.testing.assert_array_equal(toks_t, toks_j)
    assert _rel(lt, lj) <= LOGIT_RTOL


def test_convert_carries_every_leaf():
    """Every leaf of the reference's zamba2 tree reaches the port's tree,
    the shared block and the fuse projection included, with its values."""
    jc, tc, jparams, tparams, _, _, _ = _setup("off")
    assert set(tparams["blocks"]) == set(jparams["blocks"]) == {
        "seg0", "shared_attn", "fuse"}
    n = tc.n_layers
    leaves = jax.tree_util.tree_leaves_with_path(jparams)
    count = 0
    for path, leaf in leaves:
        keys = [p.key for p in path]
        node = tparams
        if keys[:2] == ["blocks", "seg0"]:
            for i in range(n):
                node = tparams["blocks"]["seg0"][i]
                for k in keys[2:]:
                    node = node[k]
                np.testing.assert_array_equal(node.numpy(),
                                              np.asarray(leaf)[i])
                count += 1
            continue
        for k in keys:
            node = node[k]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
        count += 1
    port_leaves = sum(1 for _ in _walk(tparams))
    assert count == port_leaves
    assert tuple(tparams["blocks"]["fuse"]["w"].shape) == (2 * tc.d_model,
                                                           tc.d_model)


def _walk(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _walk(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _walk(v)
    else:
        yield tree


def test_hybrid_params_and_caches():
    """The port's own init: the segment's per-layer SSM params, one shared
    block, the fuse projection; the SSM caches per layer and the shared
    block's KV cache per group."""
    tc = tsmoke(tget(ARCH))
    assert transformer.segments(tc) == [("hybrid", 4)]
    params = tmodel.init_params(0, tc, device="cpu")
    blocks = params["blocks"]
    assert len(blocks["seg0"]) == 4 and "ssm" in blocks["seg0"][0]
    assert set(blocks["shared_attn"]) == {"ln1", "ln2", "attn", "ffn"}
    caches = tmodel.init_caches(tc, 3, 20, "cpu")
    assert tuple(caches["seg0"].state.shape[:2]) == (4, 3)
    kv = caches["shared_attn"]
    assert tuple(kv.k.shape) == (2, 3, 20, tc.n_kv_heads,
                                 tc.resolved_head_dim)
    assert kv.k_scale is None and tuple(kv.pos.shape) == (2, 3)


def test_static_serve_streams_match_reference():
    """``launch.serve.serve_static`` on the CPU: the reference's greedy
    streams, and a batch served in reverse order gives the reversed
    streams."""
    jc, tc, jparams, tparams, jcal, tcal, _ = _setup("tdvmm")
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
