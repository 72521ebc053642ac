"""Layer stacks — torch port of ``repro.models.transformer``, dense
``attn_ffn`` segments only.

The JAX package stacks each segment's layer parameters along a leading axis
and ``lax.scan``s over them; here a segment is a list of per-layer parameter
dicts and a Python loop.  Caches stay stacked along a leading layer axis
(one tensor per field), and each layer reads and writes its own slice of
them in place.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, ffn


def attn_ffn_block(params, x, cfg: ModelConfig, mode: str, cache, positions,
                   key=None, page_ctx=None):
    x = common.constrain_batch(x)
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
    return x + ffn.apply(params["ffn"], h, cfg, key), new_cache


def segments(cfg: ModelConfig) -> list[tuple[str, int]]:
    if cfg.family in ("dense", "vlm", "audio"):
        return [("attn_ffn", cfg.n_layers)]
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported yet (dense only)")


def _init_attn_ffn(gen, cfg: ModelConfig, dtype, device) -> dict:
    return {
        "ln1": common.rmsnorm_init(cfg.d_model, dtype, device),
        "ln2": common.rmsnorm_init(cfg.d_model, dtype, device),
        "attn": attention.init(gen, cfg, dtype, device),
        "ffn": ffn.init(gen, cfg, dtype, device),
    }


def init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    """{"seg<i>": [per-layer params, ...]} for every segment."""
    return {f"seg{i}": [_init_attn_ffn(gen, cfg, dtype, device)
                        for _ in range(n)]
            for i, (_, n) in enumerate(segments(cfg))}


def _layer_cache(seg_cache, i: int):
    """Layer i's view of a stacked cache (a NamedTuple of (L, ...) tensors)."""
    return type(seg_cache)(*(t[i] for t in seg_cache))


def apply(params, x: torch.Tensor, cfg: ModelConfig, mode: str,
          caches: Optional[dict], positions=None, key=None,
          page_ctx=None) -> tuple[torch.Tensor, dict]:
    """Run the full stack.  Returns (x, caches); the caches are updated in
    place and returned with any per-layer fields (dense ``pos``) advanced.

    ``page_ctx`` (``runtime.paged_cache.PrefillChunkCtx`` / ``DecodeCtx``)
    rides alongside the paged modes: the block table and positions are the
    same for every layer."""
    new_caches: dict[str, Any] = {}
    for i, (_, n) in enumerate(segments(cfg)):
        seg_cache = caches[f"seg{i}"]
        pos_out = []
        for li, p in enumerate(params[f"seg{i}"]):
            x, c = attn_ffn_block(p, x, cfg, mode, _layer_cache(seg_cache, li),
                                  positions, key, page_ctx=page_ctx)
            if isinstance(c, attention.KVCache):
                pos_out.append(c.pos)
        if pos_out:
            seg_cache = seg_cache._replace(pos=torch.stack(pos_out))
        new_caches[f"seg{i}"] = seg_cache
    return x, new_caches
