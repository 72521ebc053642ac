"""Multi-head attention (GQA/MHA) with a dense KV cache and a paged KV cache
— torch port of ``repro.models.attention``, serving subset.

Weights are stored flattened, (d_model, n_heads*head_dim).  Attention is
plain torch (it is plain ``jnp`` in the JAX package too, not a Pallas
kernel); ``apply_train`` is the training forward over a whole sequence: the same f32 softmax and the same ``-1e30`` mask value.  Sliding
windows (``cfg.swa_window``, Mistral/Mixtral) run in the dense cache: a ring
of ``min(max_len, window)`` slots in which absolute position p lives at slot
p % size.  The paged cache refuses them, as the JAX package's does.  Not
ported: the int8 KV cache and the flash (online softmax) path — prompts stay
under ``FLASH_THRESHOLD``.

Caches are updated **in place**: ``apply_prefill``/``apply_decode`` write
the new keys and values into the cache tensors they are given (views into
the model's stacked per-layer caches) and return the same tensors with the
advanced positions; the paged functions write through the block table into
the page pool they are given.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common

FLASH_THRESHOLD = 2048   # the JAX package switches to flash attention above


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_cache, n_kv, head_dim)
    v: torch.Tensor
    pos: torch.Tensor        # (B,) int32 — tokens absorbed per sequence


class PagedKVCache(NamedTuple):
    k: torch.Tensor          # (num_pages+1, page_size, n_kv, head_dim); the
    #                          last page is the write sink for padded and
    #                          inactive rows
    v: torch.Tensor


def init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    bias = cfg.qkv_bias
    return {
        "wq": common.dense_init(gen, d, cfg.n_heads * hd, dtype, device, bias=bias),
        "wk": common.dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device, bias=bias),
        "wv": common.dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device, bias=bias),
        "wo": common.dense_init(gen, cfg.n_heads * hd, d, dtype, device),
    }


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))


def _qkv(params, x: torch.Tensor, cfg: ModelConfig, key=None):
    """q/k/v projections as one grouped site (``attn.qkv``)."""
    td = cfg.site_tdvmm("attn.qkv")
    hd = cfg.resolved_head_dim
    q, k, v = common.dense_group(
        (params["wq"], params["wk"], params["wv"]), x, td, key)
    return (_split_heads(q, cfg.n_heads, hd),
            _split_heads(k, cfg.n_kv_heads, hd),
            _split_heads(v, cfg.n_kv_heads, hd))


def _attend(q, k, v, mask, cfg: ModelConfig) -> torch.Tensor:
    """q: (B,Sq,H,D); k,v: (B,Skv,Kv,D); mask: (B,1,Sq,Skv) or broadcastable."""
    hd = q.shape[-1]
    groups = cfg.n_heads // cfg.n_kv_heads
    b, sq, h, _ = q.shape
    q = q.reshape(b, sq, cfg.n_kv_heads, groups, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", q, k).to(torch.float32)
    logits = logits * (hd ** -0.5)
    logits = torch.where(mask[:, :, None] if mask.dim() == 4 else mask,
                         logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, sq, h, hd)


def _causal_mask(sq: int, skv: int, offset: int, window, device
                 ) -> torch.Tensor:
    """(1, 1, sq, skv) boolean mask.  offset = absolute position of query 0;
    ``window`` (or None) keeps only the last ``window`` keys."""
    qpos = torch.arange(sq, device=device)[:, None] + offset
    kpos = torch.arange(skv, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m[None, None]


# --------------------------------------------------------------------------
# Training: full-sequence causal attention, no cache
# --------------------------------------------------------------------------
def apply_train(params, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, key=None) -> torch.Tensor:
    """Full-sequence causal (optionally sliding-window) attention through
    the grouped ``attn.qkv`` launch; x (B, S, d), positions (B, S).  Up to
    ``FLASH_THRESHOLD`` tokens only: flash attention is not ported."""
    s = x.shape[1]
    if s > FLASH_THRESHOLD:
        raise NotImplementedError(
            f"sequence of {s} tokens: flash attention (S > "
            f"{FLASH_THRESHOLD}) is not ported yet")
    q, k, v = _qkv(params, x, cfg, key)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    out = _attend(q, k, v, _causal_mask(s, s, 0, cfg.swa_window, x.device),
                  cfg)
    return common.dense_tp_reduce(params["wo"], _merge_heads(out),
                                  cfg.site_tdvmm("attn.out"), key)


# --------------------------------------------------------------------------
# Dense cache (calibration pass and the solo greedy oracle)
# --------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device) -> KVCache:
    """A (batch, size) cache; size = min(max_len, window) for a sliding
    window (a ring), else max_len."""
    size = max_len if cfg.swa_window is None else min(max_len, cfg.swa_window)
    shape = (batch, size, cfg.n_kv_heads, cfg.resolved_head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((batch,), dtype=torch.int32, device=device))


def apply_prefill(params, x: torch.Tensor, cfg: ModelConfig, cache: KVCache,
                  key=None) -> tuple[torch.Tensor, KVCache]:
    """Process a full prompt, filling the cache in place (cache.pos == 0).
    A sliding-window ring shorter than the prompt keeps its last ``size``
    tokens, rolled so that position p sits at slot p % size."""
    b, s, _ = x.shape
    if s > FLASH_THRESHOLD:
        raise NotImplementedError(
            f"prompt of {s} tokens: flash attention (S > {FLASH_THRESHOLD}) "
            "is not ported yet")
    size = cache.k.shape[1]
    if s > size and cfg.swa_window is None:
        raise ValueError(f"prompt of {s} tokens exceeds the cache ({size})")
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    q, k, v = _qkv(params, x, cfg, key)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    out = _attend(q, k, v, _causal_mask(s, s, 0, cfg.swa_window, x.device),
                  cfg)
    if size >= s:
        cache.k[:, :s] = k.to(cache.k.dtype)
        cache.v[:, :s] = v.to(cache.v.dtype)
    else:
        shift = s % size
        cache.k.copy_(torch.roll(k[:, -size:], shift, dims=1))
        cache.v.copy_(torch.roll(v[:, -size:], shift, dims=1))
    pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    y = common.dense(params["wo"], _merge_heads(out),
                     cfg.site_tdvmm("attn.out"), key)
    return y, KVCache(cache.k, cache.v, pos)


def apply_decode(params, x: torch.Tensor, cfg: ModelConfig, cache: KVCache,
                 key=None) -> tuple[torch.Tensor, KVCache]:
    """One-token decode step, x: (B, 1, d); writes the cache in place.
    A sliding-window ring writes slot pos % size and attends to the slots
    written within the last ``size`` steps; a full cache raises when
    decoding past its capacity."""
    b = x.shape[0]
    pos = cache.pos
    size = cache.k.shape[1]
    swa = cfg.swa_window is not None
    if not swa and bool(torch.any(pos >= size)):
        raise ValueError(
            f"attention.apply_decode: KV cache capacity exceeded "
            f"(pos={pos.tolist()} >= size={size})")
    q, k, v = _qkv(params, x, cfg, key)
    q = common.apply_rope(q, pos[:, None], cfg.rope_theta)
    k = common.apply_rope(k, pos[:, None], cfg.rope_theta)
    rows = torch.arange(b, device=x.device)
    slot = (pos % size if swa else pos).long()
    cache.k[rows, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[rows, slot] = v[:, 0].to(cache.v.dtype)
    kpos = torch.arange(size, device=x.device)
    if swa:
        age = (slot[:, None] - kpos[None, :]) % size
        valid = age <= torch.clamp(pos, max=size - 1)[:, None]
    else:
        valid = kpos[None, :] <= pos[:, None]
    mask = valid[:, None, None, :]                               # (B, 1, 1, S)
    out = _attend(q, cache.k.to(q.dtype), cache.v.to(q.dtype), mask, cfg)
    y = common.dense(params["wo"], _merge_heads(out),
                     cfg.site_tdvmm("attn.out"), key)
    return y, KVCache(cache.k, cache.v, pos + 1)


# --------------------------------------------------------------------------
# Paged KV cache (serving engine): block-table-indexed pages.  See
# runtime/paged_cache.py for the layout and the trash-page convention.
# --------------------------------------------------------------------------
def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     dtype, device) -> PagedKVCache:
    """One attention layer's page pool (+1 trash page)."""
    if cfg.swa_window is not None:
        raise NotImplementedError(
            "the paged cache does not hold sliding-window attention (nor does "
            "the JAX package's); serve such models through the static path")
    shape = (num_pages + 1, page_size, cfg.n_kv_heads, cfg.resolved_head_dim)
    return PagedKVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device))


def _paged_read(cache: PagedKVCache, tables: torch.Tensor, dtype):
    """Gather a slot's pages into position order.  tables: (..., P) page ids
    -> k/v (..., P*page_size, n_kv, head_dim) in the compute dtype."""
    idx = tables.long()
    k_read = cache.k[idx]                        # (..., P, ps, kv, hd)
    v_read = cache.v[idx]
    flat = k_read.shape[:-4] + (-1,) + k_read.shape[-2:]
    return k_read.reshape(flat).to(dtype), v_read.reshape(flat).to(dtype)


def apply_prefill_paged(params, x: torch.Tensor, cfg: ModelConfig,
                        cache: PagedKVCache, ctx, key=None
                        ) -> tuple[torch.Tensor, PagedKVCache]:
    """One fixed-size prefill chunk for ONE slot.  x: (1, C, d); ctx:
    ``runtime.paged_cache.PrefillChunkCtx``.

    Tokens [offset, offset + valid) are projected, rope'd at their global
    positions, written in place into the slot's pages through the block-table
    row, and attended against every page the slot owns under the global
    causal mask.  Padded rows (>= valid) write to the trash page and their
    outputs are garbage the engine drops."""
    _, c, _ = x.shape
    ps = cache.k.shape[1]
    trash = cache.k.shape[0] - 1
    n_rows = ctx.block_row.shape[0]
    ar = torch.arange(c, dtype=torch.int32, device=x.device)
    gpos = ctx.offset + ar                                   # (C,) global
    q, k, v = _qkv(params, x, cfg, key)
    q = common.apply_rope(q, gpos[None], cfg.rope_theta)
    k = common.apply_rope(k, gpos[None], cfg.rope_theta)

    pid = ctx.block_row[torch.clamp(gpos // ps, max=n_rows - 1).long()]
    pid = torch.where(ar < ctx.valid, pid, trash).long()     # (C,)
    off = (gpos % ps).long()
    cache.k[pid, off] = k[0].to(cache.k.dtype)
    cache.v[pid, off] = v[0].to(cache.v.dtype)

    k_read, v_read = _paged_read(cache, ctx.block_row[None], q.dtype)
    kpos = torch.arange(n_rows * ps, dtype=torch.int32, device=x.device)
    mask = (kpos[None, :] <= gpos[:, None]) \
        & (kpos[None, :] < ctx.offset + ctx.valid)
    out = _attend(q, k_read, v_read, mask[None, None], cfg)
    y = common.dense(params["wo"], _merge_heads(out),
                     cfg.site_tdvmm("attn.out"), key)
    return y, cache


def apply_decode_paged(params, x: torch.Tensor, cfg: ModelConfig,
                       cache: PagedKVCache, ctx, key=None
                       ) -> tuple[torch.Tensor, PagedKVCache]:
    """Batched one-token decode over all B slots.  x: (B, 1, d); ctx:
    ``runtime.paged_cache.DecodeCtx``.

    Each active slot writes its new KV in place at position ``pos`` through
    its block-table row and attends over its own gathered pages; inactive
    slots write to the trash page and produce ignored outputs.  The engine
    evicts a request before its next write would overflow its page budget,
    so there is no past-capacity path here."""
    ps = cache.k.shape[1]
    trash = cache.k.shape[0] - 1
    n_rows = ctx.block_tables.shape[1]
    pos = ctx.pos
    q, k, v = _qkv(params, x, cfg, key)
    q = common.apply_rope(q, pos[:, None], cfg.rope_theta)
    k = common.apply_rope(k, pos[:, None], cfg.rope_theta)

    page_idx = torch.clamp(pos // ps, max=n_rows - 1).long()
    pid = torch.gather(ctx.block_tables, 1, page_idx[:, None])[:, 0]
    pid = torch.where(ctx.active, pid, trash).long()         # (B,)
    off = (pos % ps).long()
    cache.k[pid, off] = k[:, 0].to(cache.k.dtype)
    cache.v[pid, off] = v[:, 0].to(cache.v.dtype)

    k_read, v_read = _paged_read(cache, ctx.block_tables, q.dtype)
    kpos = torch.arange(n_rows * ps, dtype=torch.int32, device=x.device)
    mask = (kpos[None, :] <= pos[:, None])[:, None, None, :]  # (B,1,1,cap)
    out = _attend(q, k_read, v_read, mask, cfg)
    y = common.dense(params["wo"], _merge_heads(out),
                     cfg.site_tdvmm("attn.out"), key)
    return y, cache
