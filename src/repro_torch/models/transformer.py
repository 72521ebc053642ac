"""Layer stacks — torch port of ``repro.models.transformer``: dense
``attn_ffn`` segments, the MoE family's ``first_k_dense`` ``attn_ffn``
layers followed by ``attn_moe`` layers, and the SSM family's ``ssm``
(Mamba-2) segments.  The hybrid family (zamba2) belongs to a later slice.
Serving drops the MoE router's auxiliary losses; training (``apply_train``)
sums them over the ``attn_moe`` layers, as the JAX package's ``apply`` does
in its ``"train"`` mode.  The SSM family's training forward
(``ssm.apply_train``) is not ported.

The JAX package stacks each segment's layer parameters along a leading axis
and ``lax.scan``s over them; here a segment is a list of per-layer parameter
dicts and a Python loop.  Caches stay stacked along a leading layer axis
(one tensor per field), and each layer reads and writes its own slice of
them in place.  ``cfg.remat_policy`` other than ``"none"`` checkpoints each
training block (``torch.utils.checkpoint``, non-reentrant): its activations
are recomputed in the backward pass, as ``jax.checkpoint`` does; the JAX
package's ``"save_dots"`` keeps the matmul outputs, here they are recomputed
too (the same values, more time).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, ffn, moe, ssm


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
    if "moe" in params:
        f, _ = moe.apply(params["moe"], h, cfg, key)
    else:
        f = ffn.apply(params["ffn"], h, cfg, key)
    return x + f, new_cache


def attn_ffn_train(params, x, cfg: ModelConfig, positions, key=None):
    """One attention + FFN (or MoE) block over a whole sequence: (x, lb_loss,
    z_loss), the aux losses zero for an FFN block."""
    x = common.constrain_batch(x)
    h = common.rmsnorm(params["ln1"], x, cfg.norm_eps)
    x = x + attention.apply_train(params["attn"], h, cfg, positions, key)
    h = common.rmsnorm(params["ln2"], x, cfg.norm_eps)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if "moe" in params:
        f, aux = moe.apply(params["moe"], h, cfg, key)
        return x + f, aux["lb_loss"], aux["z_loss"]
    return x + ffn.apply(params["ffn"], h, cfg, key), zero, zero


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
    x = common.constrain_batch(x)
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
        raise NotImplementedError(
            "the hybrid family (zamba2: SSM groups with a shared attention "
            "block) is not ported yet; it follows the paper-physics slice "
            "(ROADMAP A.12)")
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
         "ssm": _init_ssm}


def init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    """{"seg<i>": [per-layer params, ...]} for every segment."""
    return {f"seg{i}": [_INIT[kind](gen, cfg, dtype, device)
                        for _ in range(n)]
            for i, (kind, n) in enumerate(segments(cfg))}


def _layer_cache(seg_cache, i: int):
    """Layer i's view of a stacked cache (a NamedTuple of (L, ...) tensors)."""
    return type(seg_cache)(*(t[i] for t in seg_cache))


def apply(params, x: torch.Tensor, cfg: ModelConfig, mode: str,
          caches: Optional[dict], positions=None, key=None,
          page_ctx=None) -> tuple[torch.Tensor, dict]:
    """Run the full stack.  Returns (x, caches); the caches are updated in
    place and returned with their per-layer ``pos`` fields advanced.

    ``page_ctx`` (``runtime.paged_cache.PrefillChunkCtx`` / ``DecodeCtx``)
    rides alongside the paged modes: the block table and positions are the
    same for every layer."""
    new_caches: dict[str, Any] = {}
    for i, (kind, n) in enumerate(segments(cfg)):
        seg_cache = caches[f"seg{i}"]
        pos_out = []
        for li, p in enumerate(params[f"seg{i}"]):
            layer_cache = _layer_cache(seg_cache, li)
            if kind == "ssm":
                x, c = ssm_block(p, x, cfg, mode, layer_cache, key)
            else:
                x, c = attn_ffn_block(p, x, cfg, mode, layer_cache, positions,
                                      key, page_ctx=page_ctx)
            if isinstance(c, (attention.KVCache, ssm.SSMCache)):
                pos_out.append(c.pos)
        if pos_out:
            seg_cache = seg_cache._replace(pos=torch.stack(pos_out))
        new_caches[f"seg{i}"] = seg_cache
    return x, new_caches


def apply_train(params, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, key=None
                ) -> tuple[torch.Tensor, dict]:
    """The training forward of the full stack (the JAX package's ``apply``
    in ``"train"`` mode).  Returns (x, {"lb_loss", "z_loss"}), the MoE
    router's aux losses summed over the ``attn_moe`` layers."""
    lb, zl = [], []
    for i, (kind, _) in enumerate(segments(cfg)):
        if kind == "ssm":
            raise NotImplementedError(
                "training the SSM family (ssm.apply_train) is not ported yet")
        block = _remat(lambda p, h, _k=key: attn_ffn_train(
            p, h, cfg, positions, _k), cfg)
        for p in params[f"seg{i}"]:
            x, lb_i, z_i = block(p, x)
            if kind == "attn_moe":
                lb.append(lb_i)
                zl.append(z_i)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, {"lb_loss": torch.sum(torch.stack(lb)) if lb else zero,
               "z_loss": torch.sum(torch.stack(zl)) if zl else zero}
