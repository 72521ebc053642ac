"""The KV groups split (``meshctx.attn_split`` "groups") on gloo worlds of
CPU processes (``torch_dist_cases.World``): kimi-k2's 64 heads and 8 KV
heads of 112 lanes at a model axis of 16, where the KV heads do not divide
and 112 lanes do not split into whole rotary pairs, so each rank holds 4
query heads and the one KV head they read.  Forced at smoke width: kimi-k2
with 2 KV heads of 14 lanes on a 1 x 4 mesh (14 % 8 != 0, as 112 % 32 !=
0) and 1 KV head on 2 x 2 (FSDP in play), each against the JAX package's
meshless result on the same weights.  Also the training step's in-place
accumulator, bitwise the formula it replaced."""
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
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import meshctx
from test_torch_dist_placement import (GRAD_RTOL, INT8_RTOL, LOGIT_RTOL,
                                       LOSS_RTOL, WORLD_TIMEOUT,
                                       _check_forced, _jax_greedy, _rel,
                                       _ref_leaf)
from torch_dist_cases import World

ARCH = "kimi-k2-1t-a32b"
HD = 14
# (mesh, KV heads): the two meshes that reach "groups" at smoke width
MESHES = [((1, 4), 2), ((2, 2), 1)]


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


@functools.lru_cache(maxsize=None)
def _jax(kv: int, tdvmm: bool = False):
    """``torch_dist_cases.placement_cfg(ARCH, kv, HD)``'s JAX config (MoE
    capacity 64: no drops; every linear a TD-VMM site with ``tdvmm``) and
    its weights, made once a module."""
    cfg = jsmoke(jget(ARCH)).replace(vocab_pad_multiple=32, n_kv_heads=kv,
                                     head_dim=HD)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=64.0))
    if tdvmm:
        cfg = cfg.replace(tdvmm=JLayer(enabled=True, backend="jnp"))
    params = jax.jit(lambda key: jmodel.init_params(key, cfg))(
        jax.random.PRNGKey(2))
    return cfg, params, jax.tree.map(np.asarray, params)


def test_attn_split_of_every_arch_at_a_model_axis_of_16():
    """Only kimi-k2 takes the KV groups split at the production mesh's
    model axis of 16; every other arch keeps its mode (yi-34b, qwen2.5,
    nemotron, llava, mamba2 and mixtral the head-dim fallback, qwen1.5,
    musicgen and zamba2 heads)."""
    got = {a: meshctx.attn_split(get_config(a), 16) for a in ARCHS}
    assert got == {
        "yi-34b": "lanes", "qwen2.5-14b": "lanes", "qwen1.5-0.5b": "heads",
        "nemotron-4-15b": "lanes", "llava-next-mistral-7b": "lanes",
        "musicgen-large": "heads", "mamba2-1.3b": "lanes",
        "mixtral-8x7b": "lanes", "kimi-k2-1t-a32b": "groups",
        "zamba2-2.7b": "heads"}
    for (shape, kv) in MESHES:
        cfg = cases.placement_cfg(ARCH, kv, HD)
        assert meshctx.attn_split(cfg, shape[1]) == "groups"


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("shape,kv", MESHES)
def test_kv_groups_dense_cache(world, shape, kv, int8):
    """Prefill and decode, teacher-forced with the JAX greedy stream, on
    the dense cache of one KV head a rank (int8: the rank's own per-(token,
    head) scales): every step's logits within LOGIT_RTOL (INT8_RTOL) of
    the JAX meshless run, the same greedy token."""
    cfg, params, pn = _jax(kv)
    prompts = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int64)
    toks, want = _jax_greedy(cfg, params, prompts, 5, int8)
    for r in world.run(cases.forced_on_mesh, ARCH, pn, prompts, toks, shape,
                       kv, int8, 0, "", HD):
        _check_forced(r["logits"], want, INT8_RTOL if int8 else LOGIT_RTOL)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("shape,kv", MESHES)
def test_kv_groups_paged_engine(world, shape, kv, int8):
    """The paged engine with page pools of one KV head a rank
    (``sharding.paged_specs``): the JAX meshless engine's streams, finish
    reasons and finish steps, the meshless engine with as many slots as
    the mesh's data ranks hold together."""
    cfg, params, pn = _jax(kv)
    rng = np.random.default_rng(12)
    requests = [dict(rid=i, prompt=tuple(int(t) for t in rng.integers(
        0, cfg.vocab_size, int(rng.integers(3, 9)))),
        max_new_tokens=int(rng.integers(2, 6)), arrival_step=i // 2)
        for i in range(4)]
    ecfg = dict(slots=2, page_size=4, num_pages=32, chunk=4)
    jattention.set_kv_cache_int8(int8)
    try:
        rep = JEngine(cfg, params, JEcfg(**dict(
            ecfg, slots=ecfg["slots"] * shape[0]))).run(
            [JRequest(**r) for r in requests])
    finally:
        jattention.set_kv_cache_int8(False)
    want = [[q["rid"], q["tokens"], q["finish_reason"], q["finished_step"]]
            for q in rep.requests]
    for got in world.run(cases.engine_on_mesh, pn, requests, ecfg, shape,
                         kv, int8, ARCH, HD):
        assert got == want


@functools.lru_cache(maxsize=None)
def _jax_qat(kv: int):
    """The JAX package's QAT loss and gradients (aux coefficients 0) on
    the smoke kimi-k2 of ``kv`` KV heads: (weights, batch, loss, grads)."""
    jc, params, pn = _jax(kv, tdvmm=True)
    rng = np.random.default_rng(13)
    toks = rng.integers(0, jc.vocab_size, (4, 8)).astype(np.int64)
    batch = {"inputs": toks, "targets": np.roll(toks, -1, axis=1)}
    (loss, _), grads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, jc,
                                 lb_coef=0.0, z_coef=0.0),
        has_aux=True)(params)
    return pn, batch, float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("shape,kv", MESHES)
def test_kv_groups_qat_step(world, shape, kv):
    """One QAT step (every linear a 6-bit TD-VMM site, the experts' too):
    the loss within LOSS_RTOL and every leaf's gradient within GRAD_RTOL of
    the JAX meshless ``loss_fn``'s, ``wk`` / ``wv`` included (each rank's
    copy holds its query heads' part; the step sums them over the KV
    group).  After the update every copy of a KV head (parameters and
    AdamW moments) is bitwise the same on the ranks of its group."""
    pn, batch, loss, gn = _jax_qat(kv)
    out = world.run(cases.kv_group_qat, pn, batch, shape, kv, HD)
    r0 = out[0]
    assert r0["split"] == "groups"
    assert abs(r0["loss"] - loss) <= LOSS_RTOL * abs(loss)
    for path, g in r0["grads"].items():
        assert _rel(g, _ref_leaf(gn, path)) <= GRAD_RTOL, path
    tp = shape[1]
    per_group = tp // kv
    assert r0["kv_leaves"]
    for d in range(shape[0]):
        for h in range(kv):
            ranks = [d * tp + h * per_group + i for i in range(per_group)]
            first = out[ranks[0]]["kv_leaves"]
            for r in ranks[1:]:
                for p, t in out[r]["kv_leaves"].items():
                    assert np.array_equal(t.view(np.uint8),
                                          first[p].view(np.uint8)), (r, p)


def test_kv_groups_noisy_codes_on_shards(world):
    """Programming noise at the grouped q/k/v launch under the KV groups
    split: each rank's noisy codes of ``wq``'s heads and of its KV head's
    ``wk`` / ``wv`` columns are the meshless bank's, bitwise (the draws of
    the whole bank, ``wk`` / ``wv`` 2 heads wide, not 4 x the shard)."""
    for seed in (0, 1):
        assert world.run(cases.kv_group_noise, seed) == [[]] * 4


@pytest.mark.parametrize("to", [(4, 1), (1, 4)])
def test_kv_groups_checkpoint_elastic_restore(world, tmp_path, to):
    """A 2 x 2 state under the KV groups split, gathered whole (each KV
    head written once) and restored on 4 x 1 (heads) and 1 x 4 (groups
    again, four ranks to the KV head): whole leaves and shards exact."""
    for r in world.run(cases.kv_group_checkpoint, str(tmp_path), 1, HD, to):
        assert r["step"] == 3 and r["groups_leaves"] > 0
        assert r["saved_exact"] and r["exact"] and r["shards_exact"]


@pytest.mark.parametrize("shape,arch,kv,hd", [
    (None, "qwen1.5-0.5b", 0, 0),
    ((2, 2), "qwen1.5-0.5b", 0, 0),
    ((2, 2), ARCH, 1, HD),
])
def test_accumulation_in_place_is_bitwise(world, shape, arch, kv, hd):
    """Two steps of 2 microbatches (a data rank's) in bfloat16, meshless
    and on 2 x 2 (qwen by heads, the smoke kimi-k2 by KV groups): the
    in-place float32 accumulator gives the TrainState and metrics of the
    formula it replaced (a new tree per microbatch, ``a + b.to(float32)``,
    then ``/ accum``), bit for bit."""
    rng = np.random.default_rng(14)
    toks = rng.integers(0, 512, (8, 8)).astype(np.int64)
    batch = {"inputs": toks, "targets": np.roll(toks, -1, axis=1)}
    if shape is None:
        out = [cases.accumulation_bitwise(arch, batch, None, 2, kv, hd)]
    else:
        out = world.run(cases.accumulation_bitwise, arch, batch, shape, 2,
                        kv, hd)
    for r in out:
        assert r["leaves"] > 10 and r["bitwise"] and r["metrics"], r


def test_mesh_kimi_phase_on_the_cpu():
    """``chip_smoke.mesh_kimi`` (the card's "mesh kimi" phase) at a small
    width on the CPU: 16 heads and 8 KV heads of 14 lanes over a model
    axis of 16, each rank a head and its KV head, the 16 shards from
    ``local_config`` and ``sharding.shard``: every shard's attention
    output and cache, and the rank-order sum of the ``wo`` partials,
    bitwise the meshless layer's in the mesh's order; a shard's cache 1/8
    of the meshless one."""
    import torch
    cs = cases._chip_smoke()
    cfg = cs.kimi_config().replace(d_model=64, n_heads=16, n_kv_heads=8,
                                   head_dim=14)
    r = cs.mesh_kimi(torch.device("cpu"), cfg, (2, 12), 3)
    assert r["steps"] == 4 and 8 * r["shard_cache_bytes"] == r["cache_bytes"]
