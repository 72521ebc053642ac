"""Layer stacks — torch port of ``repro.models.transformer``: dense
``attn_ffn`` segments, the MoE family's ``first_k_dense`` ``attn_ffn``
layers followed by ``attn_moe`` layers, the SSM family's ``ssm`` (Mamba-2)
segments, and the hybrid family's (zamba2) ``hybrid`` segment: groups of
``hybrid_attn_every`` Mamba-2 layers, each followed by ONE shared
attention + FFN block (a single parameter set, reused by every group),
fed ``fuse(concat(x, embed0))`` when ``hybrid_concat_embed`` is set
(under a ``model`` axis: the SSM layers as ``models.ssm`` shards them,
the shared block by heads, ``fuse`` by columns, all-gathered).
Serving drops the MoE router's auxiliary losses; training (``apply_train``)
sums them over the ``attn_moe`` layers, as the JAX package's ``apply`` does
in its ``"train"`` mode, and runs every family (the SSM and hybrid ones
through ``ssm.apply_train``).

The JAX package stacks each segment's layer parameters along a leading axis
and ``lax.scan``s over them; here a segment is a list of per-layer parameter
dicts and a Python loop (hybrid group g is layers ``[g·every, (g+1)·every)``
of its list).  Caches stay stacked along a leading layer axis (one tensor
per field; the shared block's along the group axis), and each layer reads
and writes its own slice of them in place.  ``cfg.remat_policy`` other than
``"none"`` checkpoints each training block (``torch.utils.checkpoint``,
non-reentrant): its activations are recomputed in the backward pass, as
``jax.checkpoint`` does; the JAX package's ``"save_dots"`` keeps the matmul
outputs, here they are recomputed too (the same values, more time).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, ffn, moe, ssm


def attn_ffn_block(params, x, cfg: ModelConfig, mode: str, cache, positions,
                   key=None, page_ctx=None):
    h = common.rmsnorm(params["ln1"], x, cfg.norm_eps)
    if mode == "prefill":
        a, new_cache = attention.apply_prefill(params["attn"], h, cfg, cache, key)
    elif mode == "prefill_paged":
        a, new_cache = attention.apply_prefill_paged(
            params["attn"], h, cfg, cache, page_ctx, key)
    elif mode == "decode_paged":
        a, new_cache = attention.apply_decode_paged(
            params["attn"], h, cfg, cache, page_ctx, key)
    elif mode == "decode":
        a, new_cache = attention.apply_decode(params["attn"], h, cfg, cache, key)
    else:
        raise NotImplementedError(f"mode {mode!r} is not ported yet")
    x = x + a
    h = common.rmsnorm(params["ln2"], x, cfg.norm_eps)
    if "moe" in params:
        f, _ = moe.apply(params["moe"], h, cfg, key)
    else:
        f = ffn.apply(params["ffn"], h, cfg, key)
    return x + f, new_cache


def attn_ffn_train(params, x, cfg: ModelConfig, positions, key=None):
    """One attention + FFN (or MoE) block over a whole sequence: (x, lb_loss,
    z_loss), the aux losses zero for an FFN block."""
    h = common.rmsnorm(params["ln1"], x, cfg.norm_eps)
    x = x + attention.apply_train(params["attn"], h, cfg, positions, key)
    h = common.rmsnorm(params["ln2"], x, cfg.norm_eps)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if "moe" in params:
        f, aux = moe.apply(params["moe"], h, cfg, key)
        return x + f, aux["lb_loss"], aux["z_loss"]
    return x + ffn.apply(params["ffn"], h, cfg, key), zero, zero


def _fuse(params, x, embed0, cfg: ModelConfig, key=None):
    """The hybrid family's ``fuse(concat(x, embed0))`` (site
    ``hybrid.fuse``): column-parallel under a ``model`` axis (its d_model
    columns split, as the JAX package places ``fuse/w``), the columns
    all-gathered into the replicated stream."""
    from repro_torch.launch import meshctx
    y = common.dense(params, torch.cat([x, embed0], dim=-1),
                     cfg.site_tdvmm("hybrid.fuse"), key)
    return meshctx.gather_from_tp(y, -1)


def _remat(fn, cfg: ModelConfig):
    if cfg.remat_policy == "none":
        return fn

    def checkpointed(*args):
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return checkpointed


def ssm_block(params, x, cfg: ModelConfig, mode: str, cache, key=None):
    if mode in ("prefill_paged", "decode_paged"):
        raise NotImplementedError(
            "paged serving covers attention families only; SSM state is "
            "O(1) per slot (serve SSM models through the static path)")
    h = common.rmsnorm(params["ln"], x, cfg.norm_eps)
    if mode == "prefill":
        y, new_cache = ssm.apply_prefill(params["ssm"], h, cfg, cache, key)
    elif mode == "decode":
        y, new_cache = ssm.apply_decode(params["ssm"], h, cfg, cache, key)
    else:
        raise NotImplementedError(f"mode {mode!r} is not ported yet")
    return x + y, new_cache


def segments(cfg: ModelConfig) -> list[tuple[str, int]]:
    if cfg.family in ("dense", "vlm", "audio"):
        return [("attn_ffn", cfg.n_layers)]
    if cfg.family == "moe":
        k = cfg.moe.first_k_dense
        return ([("attn_ffn", k)] if k else []) + [
            ("attn_moe", cfg.n_layers - k)]
    if cfg.family == "ssm":
        return [("ssm", cfg.n_layers)]
    if cfg.family == "hybrid":
        return [("hybrid", cfg.n_layers)]
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported yet")


def _init_attn_ffn(gen, cfg: ModelConfig, dtype, device) -> dict:
    return {
        "ln1": common.rmsnorm_init(cfg.d_model, dtype, device),
        "ln2": common.rmsnorm_init(cfg.d_model, dtype, device),
        "attn": attention.init(gen, cfg, dtype, device),
        "ffn": ffn.init(gen, cfg, dtype, device),
    }


def _init_attn_moe(gen, cfg: ModelConfig, dtype, device) -> dict:
    return {
        "ln1": common.rmsnorm_init(cfg.d_model, dtype, device),
        "ln2": common.rmsnorm_init(cfg.d_model, dtype, device),
        "attn": attention.init(gen, cfg, dtype, device),
        "moe": moe.init(gen, cfg, dtype, device),
    }


def _init_ssm(gen, cfg: ModelConfig, dtype, device) -> dict:
    return {
        "ln": common.rmsnorm_init(cfg.d_model, dtype, device),
        "ssm": ssm.init(gen, cfg, dtype, device),
    }


_INIT = {"attn_ffn": _init_attn_ffn, "attn_moe": _init_attn_moe,
         "ssm": _init_ssm, "hybrid": _init_ssm}


def hybrid_groups(cfg: ModelConfig, n: int) -> tuple[int, int]:
    """(groups, layers per group) of a hybrid segment of n SSM layers."""
    every = cfg.hybrid_attn_every or n
    if n % every:
        raise ValueError(f"hybrid segment of {n} layers is not a whole "
                         f"number of groups of {every}")
    return n // every, every


def init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    """{"seg<i>": [per-layer params, ...]} for every segment; the hybrid
    family adds the shared block ``"shared_attn"`` and, with
    ``hybrid_concat_embed``, the 2·d -> d ``"fuse"`` projection."""
    params: dict[str, Any] = {
        f"seg{i}": [_INIT[kind](gen, cfg, dtype, device) for _ in range(n)]
        for i, (kind, n) in enumerate(segments(cfg))}
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        params["shared_attn"] = _init_attn_ffn(gen, cfg, dtype, device)
        if cfg.hybrid_concat_embed:
            params["fuse"] = common.dense_init(gen, 2 * cfg.d_model,
                                               cfg.d_model, dtype, device)
    return params


def _layer_cache(seg_cache, i: int):
    """Layer i's view of a stacked cache (a NamedTuple of (L, ...) tensors,
    None for a field the cache does not hold)."""
    return type(seg_cache)(*(None if t is None else t[i] for t in seg_cache))


def _advance(stacked, pos_out: list):
    """A stacked cache with its per-layer ``pos`` advanced (paged pools,
    which have none, come back as they are)."""
    if pos_out:
        return stacked._replace(pos=torch.stack(pos_out))
    return stacked


def apply(params, x: torch.Tensor, cfg: ModelConfig, mode: str,
          caches: Optional[dict], positions=None, embed0=None, key=None,
          page_ctx=None) -> tuple[torch.Tensor, dict]:
    """Run the full stack.  Returns (x, caches); the caches are updated in
    place and returned with their per-layer ``pos`` fields advanced.

    ``embed0`` is the step's input embedding, which the hybrid family's
    shared block takes in beside x.  ``page_ctx``
    (``runtime.paged_cache.PrefillChunkCtx`` / ``DecodeCtx``) rides
    alongside the paged modes: the block table and positions are the same
    for every layer."""
    new_caches: dict[str, Any] = {}
    for i, (kind, n) in enumerate(segments(cfg)):
        seg_cache = caches[f"seg{i}"]
        layers = params[f"seg{i}"]
        pos_out = []

        def ssm_layer(li, x):
            x, c = ssm_block(layers[li], x, cfg, mode,
                             _layer_cache(seg_cache, li), key)
            pos_out.append(c.pos)
            return x

        if kind == "ssm":
            for li in range(n):
                x = ssm_layer(li, x)
        elif kind == "hybrid":
            n_groups, every = hybrid_groups(cfg, n)
            shared = caches["shared_attn"]
            shared_pos = []
            for g in range(n_groups):
                for li in range(g * every, (g + 1) * every):
                    x = ssm_layer(li, x)
                if cfg.hybrid_concat_embed and embed0 is not None:
                    x = _fuse(params["fuse"], x, embed0, cfg, key)
                x, c = attn_ffn_block(params["shared_attn"], x, cfg, mode,
                                      _layer_cache(shared, g), positions, key,
                                      page_ctx=page_ctx)
                shared_pos.append(c.pos)
            new_caches["shared_attn"] = _advance(shared, shared_pos)
        else:
            for li, p in enumerate(layers):
                x, c = attn_ffn_block(p, x, cfg, mode,
                                      _layer_cache(seg_cache, li), positions,
                                      key, page_ctx=page_ctx)
                if isinstance(c, attention.KVCache):
                    pos_out.append(c.pos)
        new_caches[f"seg{i}"] = _advance(seg_cache, pos_out)
    return x, new_caches


def ssm_train(params, x, cfg: ModelConfig, key=None):
    """One Mamba-2 block over a whole sequence."""
    h = common.rmsnorm(params["ln"], x, cfg.norm_eps)
    return x + ssm.apply_train(params["ssm"], h, cfg, key)


def apply_train(params, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, key=None, embed0=None
                ) -> tuple[torch.Tensor, dict]:
    """The training forward of the full stack (the JAX package's ``apply``
    in ``"train"`` mode).  Returns (x, {"lb_loss", "z_loss"}), the MoE
    router's aux losses summed over the ``attn_moe`` layers.  ``embed0``
    is the input embedding the hybrid family's ``fuse`` takes in."""
    lb, zl = [], []
    block = _remat(lambda p, h, _k=key: attn_ffn_train(
        p, h, cfg, positions, _k), cfg)
    ssm_layer = _remat(lambda p, h, _k=key: ssm_train(p, h, cfg, _k), cfg)
    for i, (kind, n) in enumerate(segments(cfg)):
        layers = params[f"seg{i}"]
        if kind == "ssm":
            for p in layers:
                x = ssm_layer(p, x)
        elif kind == "hybrid":
            n_groups, every = hybrid_groups(cfg, n)
            for g in range(n_groups):
                for p in layers[g * every:(g + 1) * every]:
                    x = ssm_layer(p, x)
                if cfg.hybrid_concat_embed and embed0 is not None:
                    x = _fuse(params["fuse"], x, embed0, cfg, key)
                x, _, _ = block(params["shared_attn"], x)
        else:
            for p in layers:
                x, lb_i, z_i = block(p, x)
                if kind == "attn_moe":
                    lb.append(lb_i)
                    zl.append(z_i)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, {"lb_loss": torch.sum(torch.stack(lb)) if lb else zero,
               "z_loss": torch.sum(torch.stack(zl)) if zl else zero}
