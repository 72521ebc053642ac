"""The production mesh's placements on gloo worlds of CPU processes
(``torch_dist_cases.World``, spawned once a size for the file): the SSM
and hybrid families under tensor parallelism, the head-dim fallback
(every head kept, its lanes split over ``model``), the sequence-split
dense cache of a batch the data axes do not divide, and TD-VMM training
(gradients, programming noise) under tensor parallelism, each against the
JAX package's meshless result on the same weights (its mesh path does not
run under this jax: ``ShardingTypeError``)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_cases as cases
from repro.configs import TDVMMLayerConfig as JLayer
from repro.configs import get_config as jget
from repro.configs import smoke as jsmoke
from repro.models import attention as jattention
from repro.models import model as jmodel
from repro.runtime.engine import Engine as JEngine
from repro.runtime.engine import EngineConfig as JEcfg
from repro.runtime.engine import Request as JRequest
from torch_dist_cases import World

# logits against the JAX meshless run, over max|logit| (as
# test_torch_dist_mesh.py's LOGIT_RTOL): the same float32 algebra summed in
# other orders (row-parallel reductions, the fallback's partial scores
# summed over ``model``, the gated norm's sum of squares, the sequence
# split's softmax sums and products over the data axes); measured below
# 2e-6
LOGIT_RTOL = 1e-5
# the int8 KV cache: the JAX test's own bound between the int8 decode and
# the full-precision forward is 0.15; against the JAX int8 path the codes
# are the same but a value at a rounding edge may take the neighbouring
# code after a reordered sum upstream (measured below 1e-5)
INT8_RTOL = 1e-4
# a training step's gradients, as tests/test_torch_train.py's GRAD_RTOL and
# LOSS_RTOL (per leaf, of the leaf's max|g|)
GRAD_RTOL = 1e-5
LOSS_RTOL = 1e-6
WORLD_TIMEOUT = 180.0


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module")
def world():
    with World(4, timeout=WORLD_TIMEOUT) as w:
        yield w


@pytest.fixture(scope="module")
def world2():
    with World(2, timeout=WORLD_TIMEOUT) as w:
        yield w


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@functools.lru_cache(maxsize=None)
def _jax(arch, kv=0):
    """``torch_dist_cases.placement_cfg``'s JAX config (MoE capacity 64:
    no drops) and its weights (made once a module)."""
    cfg = jsmoke(jget(arch)).replace(vocab_pad_multiple=32)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=64.0))
    if kv:
        cfg = cfg.replace(n_kv_heads=kv)
    # jitted: the eager init of the smoke zamba2 alone takes ~12 s here
    params = jax.jit(lambda key: jmodel.init_params(key, cfg))(
        jax.random.PRNGKey(1))
    return cfg, params, jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _greedy(arch, kv, batch, prompt_len, steps, seed, int8=False):
    """``_jax_greedy`` of ``arch``'s smoke weights on a seeded prompt
    (made once a module: the SSM / hybrid and the sequence-split tests
    share theirs): (prompts, tokens, logits, the weights as numpy)."""
    cfg, params, pn = _jax(arch, kv)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int64)
    toks, want = _jax_greedy(cfg, params, prompts, steps, int8)
    return prompts, toks, want, pn


def _jax_greedy(cfg, params, prompts, steps, int8=False):
    """The JAX package's static path, greedy: (the (B, steps) tokens,
    every step's (B, V) logits)."""
    jattention.set_kv_cache_int8(int8)
    try:
        b, s = prompts.shape
        caches = jmodel.init_caches(cfg, b, s + steps)
        prefill = jax.jit(lambda p, x, c: jmodel.prefill_step(p, x, c, cfg))
        decode = jax.jit(lambda p, x, c: jmodel.decode_step(p, x, c, cfg))
        logits, caches = prefill(params, {"inputs": jnp.asarray(prompts)},
                                 caches)
        out = [np.asarray(logits[:, -1], np.float32)]
        toks = [out[-1].argmax(-1)]
        for _ in range(steps - 1):
            logits, caches = decode(
                params, {"inputs": jnp.asarray(toks[-1][:, None])}, caches)
            out.append(np.asarray(logits[:, -1], np.float32))
            toks.append(out[-1].argmax(-1))
    finally:
        jattention.set_kv_cache_int8(False)
    return np.stack(toks, 1).astype(np.int64), out


def _check_forced(got, want, rtol):
    for i, (a, b) in enumerate(zip(got, want)):
        assert _rel(a, b) <= rtol, (i, _rel(a, b))
        assert np.array_equal(a.argmax(-1), b.argmax(-1)), i


# --------------------------------------------------------------------------
# SSM and hybrid families under tensor parallelism
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_ssm_and_hybrid_streams_on_tp_meshes(world, world2, arch):
    """Prefill and greedy decode (teacher-forced with the JAX stream) at
    1 x 2 and 2 x 2: every step's logits within LOGIT_RTOL of the JAX
    meshless run, the same greedy stream; at 1 x 2 also bitwise the
    port's meshless run in TP's order (``chip_smoke.tp_order``: the gated
    norm's sum of squares and the row-parallel products as two partial
    sums added in rank order)."""
    prompts, toks, want, pn = _greedy(arch, 0, 2, 8, 4, 3)
    r = world2.run(cases.forced_on_mesh, arch, pn, prompts, toks, (1, 2),
                   0, False, 0, "tp")[0]
    _check_forced(r["logits"], want, LOGIT_RTOL)
    assert all(np.array_equal(a, b) for a, b in zip(r["logits"], r["ctrl"]))
    r = world.run(cases.forced_on_mesh, arch, pn, prompts, toks, (2, 2))[0]
    _check_forced(r["logits"], want, LOGIT_RTOL)


# --------------------------------------------------------------------------
# The head-dim fallback
# --------------------------------------------------------------------------
@pytest.mark.parametrize("int8", [False, True])
def test_head_dim_fallback_dense_cache(world, int8):
    """2 KV heads over a model axis of 4: every head keeps 4 of its 16
    lanes on each rank (whole rotary pairs), the scores are partial dot
    products summed over ``model``; the int8 cache's per-(token, head)
    scale is a max over every rank's lanes.  Prefill and decode within
    the bound of the JAX meshless run, the same greedy stream."""
    prompts, toks, want, pn = _greedy("yi-34b", 2, 2, 10, 5, 5, int8)
    r = world.run(cases.forced_on_mesh, "yi-34b", pn, prompts, toks, (1, 4),
                  2, int8)[0]
    _check_forced(r["logits"], want, INT8_RTOL if int8 else LOGIT_RTOL)


@pytest.mark.parametrize("int8", [False, True])
def test_head_dim_fallback_paged_engine(world, int8):
    """The paged engine on 1 x 4 with the fallback's page pools (lanes of
    every KV head): the JAX meshless engine's streams, finish reasons and
    finish steps."""
    cfg, params, pn = _jax("yi-34b", kv=2)
    rng = np.random.default_rng(8)
    requests = [dict(rid=i, prompt=tuple(int(t) for t in rng.integers(
        0, cfg.vocab_size, int(rng.integers(3, 9)))),
        max_new_tokens=int(rng.integers(2, 6)), arrival_step=i // 2)
        for i in range(4)]
    ecfg = dict(slots=2, page_size=4, num_pages=32, chunk=4)
    jattention.set_kv_cache_int8(int8)
    try:
        rep = JEngine(cfg, params, JEcfg(**ecfg)).run(
            [JRequest(**r) for r in requests])
    finally:
        jattention.set_kv_cache_int8(False)
    want = [[q["rid"], q["tokens"], q["finish_reason"], q["finished_step"]]
            for q in rep.requests]
    for got in world.run(cases.engine_on_mesh, pn, requests, ecfg, (1, 4),
                         2, int8):
        assert got == want


# --------------------------------------------------------------------------
# The sequence-split cache
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape", [
    ("zamba2-2.7b", (2, 1)),
    ("yi-34b", (4, 1)),
    ("mixtral-8x7b", (2, 1)),       # a sliding-window ring, split
])
def test_sequence_split_cache_with_batch_one(world, world2, arch, shape):
    """Batch 1 on a data axis of 2 or 4: each data rank holds a segment of
    the cache (flash blocks of 4 tokens, so the prompt's whole attention
    is blocked and a rank's segment spans several), writes the positions
    it owns, and a decode step takes the softmax's max and sum over every
    rank's keys and sums the ranks' float32 partial products; mixtral's
    ring (window 8) wraps in decode.  Within LOGIT_RTOL of the JAX
    meshless run, the same stream; at 2 x 1 bitwise the port's meshless
    run in the split's order (``chip_smoke.seq_order``: two partial sums
    added in rank order, as a reduction over two ranks adds them; over
    four, gloo's reduction order is its own)."""
    prompts, toks, want, pn = _greedy(
        arch, 0, 1, 6 if arch.startswith("mixtral") else 10, 6, 6)
    w = world2 if shape[0] == 2 else world
    for r in w.run(cases.forced_on_mesh, arch, pn, prompts, toks, shape, 0,
                   False, 4, "seq" if shape[0] == 2 else ""):
        _check_forced(r["logits"], want, LOGIT_RTOL)
        if r["ctrl"] is not None:
            assert all(np.array_equal(a, b)
                       for a, b in zip(r["logits"], r["ctrl"]))


# --------------------------------------------------------------------------
# TD-VMM training under tensor parallelism
# --------------------------------------------------------------------------
def _qat_batch(cfg):
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int64)
    return {"inputs": toks, "targets": np.roll(toks, -1, axis=1)}


@functools.lru_cache(maxsize=None)
def _jax_qat():
    """The JAX package's QAT loss and gradients on the smoke qwen (every
    linear a TD-VMM site), once a module: (weights, batch, loss, grads)."""
    jc = jsmoke(jget("qwen1.5-0.5b")).replace(
        tdvmm=JLayer(enabled=True, backend="jnp"))
    params = jmodel.init_params(jax.random.PRNGKey(0), jc)
    batch = _qat_batch(jc)
    # eager, weights and step, as tests/test_torch_train.py runs them
    (loss, _), grads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, jc),
        has_aux=True)(params)
    return (jax.tree.map(np.asarray, params), batch, float(loss),
            jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_qat_step_under_tp_matches_jax_gradients(world, shape):
    """One QAT step (every linear a 6-bit TD-VMM site) on 1 x 4 and 2 x 2:
    a row site takes the reference's custom gradient on its slices, a
    column site's x gradient is summed over ``model``.  The loss within
    LOSS_RTOL and every leaf's gradient within GRAD_RTOL of the JAX
    meshless ``loss_fn``."""
    pn, batch, loss, gn = _jax_qat()
    out = world.run(cases.qat_grads_on_mesh, pn, batch, shape)[0]
    assert abs(out["loss"] - loss) <= LOSS_RTOL * abs(loss)
    for path, g in out["grads"].items():
        assert _rel(g, _ref_leaf(gn, path)) <= GRAD_RTOL, path


def _ref_leaf(tree_np, path: str):
    """The JAX leaf for a port path: a layer index picks a stacked row."""
    node, idx = tree_np, None
    for p in path.split("/"):
        if p.isdigit() and isinstance(node, dict) and p not in node:
            idx = int(p)
            continue
        node = node[p]
    return node if idx is None else node[idx]


def test_noisy_qat_step_under_tp(world):
    """Programming noise under TP: each shard's noisy codes are the
    meshless bank's, drawn for the whole weight from the site's key and
    sliced (column, row, expert and grouped sites, bitwise); a noisy QAT
    step on 2 x 2 within GRAD_RTOL / LOSS_RTOL of the meshless port's
    with the same key (the JAX package's jax.random draws differ)."""
    for seed in (0, 1):
        for r in world.run(cases.noisy_codes_on_shards, seed):
            assert r["bad"] == [] and r["held"] == 7, r
    jc = jsmoke(jget("qwen1.5-0.5b"))
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key: jmodel.init_params(key, jc))(jax.random.PRNGKey(0)))
    out = world.run(cases.qat_grads_on_mesh, params, _qat_batch(jc), (2, 2),
                    7)[0]
    assert abs(out["loss"] - out["meshless_loss"]) <= \
        LOSS_RTOL * abs(out["meshless_loss"])
    for path, g in out["grads"].items():
        assert _rel(g, out["meshless"][path]) <= GRAD_RTOL, path
