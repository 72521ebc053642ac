"""Multi-head attention (GQA/MHA) with a dense KV cache and a paged KV cache
— torch port of ``repro.models.attention``.

Weights are stored flattened, (d_model, n_heads*head_dim).  Attention is
plain torch (it is plain ``jnp`` in the JAX package too, not a Pallas
kernel): the same f32 softmax and the same ``-1e30`` mask value.  Above
``FLASH_THRESHOLD`` tokens ``apply_train`` and ``apply_prefill`` switch to
flash attention (``_flash``): a loop over key blocks with an online softmax
that never holds the (Sq, Skv) logits, in the JAX package's association
(``_attend_flash`` visits every tile pair, ``_attend_flash_blocks`` only the
causal / in-window ones, under ``FLASH_BLOCK_SKIP``).  Sliding windows
(``cfg.swa_window``, Mistral/Mixtral) run in the dense cache: a ring of
``min(max_len, window)`` slots in which absolute position p lives at slot
p % size.  The paged cache refuses them, as the JAX package's does.

``set_kv_cache_int8(True)`` stores keys and values as int8 codes with one
float32 scale per (token, head) (``_kv_quantize``), in the dense cache and
in the page pools alike; attention reads them back dequantized.  Every
written position carries its own fresh scale, and stale positions are
masked out, so a reused page leaks nothing.  In int8 mode the paged prefill
attends over the codes it just wrote while the dense prefill attends over
the full-precision keys before storing them: the engine's streams then
equal the engine's own solo streams, not the dense path's.

Caches are updated **in place**: ``apply_prefill``/``apply_decode`` write
the new keys and values into the cache tensors they are given (views into
the model's stacked per-layer caches) and return the same tensors with the
advanced positions; the paged functions write through the block table into
the page pool they are given.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common

FLASH_THRESHOLD = 2048   # online-softmax blocked attention above this S
FLASH_BLOCK_Q = 1024
FLASH_BLOCK_KV = 1024
FLASH_BLOCK_SKIP = False  # iterate only the causal / in-window tile pairs


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_cache, n_kv, head_dim) model dtype or int8
    v: torch.Tensor
    pos: torch.Tensor        # (B,) int32 — tokens absorbed per sequence
    k_scale: Optional[torch.Tensor] = None   # (B, S_cache, n_kv) int8 mode
    v_scale: Optional[torch.Tensor] = None


class PagedKVCache(NamedTuple):
    k: torch.Tensor          # (num_pages+1, page_size, n_kv, head_dim); the
    #                          last page is the write sink for padded and
    #                          inactive rows
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None   # (num_pages+1, page_size, n_kv)
    v_scale: Optional[torch.Tensor] = None


KV_CACHE_INT8 = False


def set_kv_cache_int8(on: bool) -> None:
    """Store the caches made from now on as int8 codes with per-(token,
    head) scales (``init_cache``, ``init_paged_cache``)."""
    global KV_CACHE_INT8
    KV_CACHE_INT8 = on


def _kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) -> int8 codes + per-(token, head) float32 scale, computed in
    x's dtype as the JAX package does."""
    scale = torch.clamp_min(torch.amax(torch.abs(x), dim=-1), 1e-6) / 127.0
    codes = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale.to(torch.float32)


def _kv_dequantize(codes: torch.Tensor, scale: torch.Tensor,
                   dtype) -> torch.Tensor:
    return (codes.to(torch.float32) * scale[..., None]).to(dtype)


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
# Flash attention (online softmax over key blocks)
# --------------------------------------------------------------------------
def _pad_seq(x: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)) if pad else x


def _attend_flash(q, k, v, cfg: ModelConfig, q_offset: int = 0
                  ) -> torch.Tensor:
    """Blocked causal attention with an online softmax, never holding the
    (Sq, Skv) logits: for each query block a loop over every key block
    carries the running (max, denom, acc) in float32.

    q: (B, Sq, H, D); k, v: (B, Skv, Kv, D).  Causal plus the optional
    sliding window, query positions offset by ``q_offset``.  Lengths that
    are not block multiples are zero-padded to the block grid and the key
    tail is masked; padded query rows are dropped."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    kvh = cfg.n_kv_heads
    g = h // kvh
    bq = min(FLASH_BLOCK_Q, sq)
    bkv = min(FLASH_BLOCK_KV, skv)
    sq_real, skv_real = sq, skv
    pad_q, pad_kv = (-sq) % bq, (-skv) % bkv
    q = _pad_seq(q, pad_q)
    k, v = _pad_seq(k, pad_kv), _pad_seq(v, pad_kv)
    sq, skv = sq + pad_q, skv + pad_kv
    nq, nkv = sq // bq, skv // bkv
    scale = d ** -0.5
    window = cfg.swa_window
    f32 = torch.float32
    dev = q.device

    qr = q.reshape(b, nq, bq, kvh, g, d).permute(1, 0, 3, 4, 2, 5)  # (nq,b,kv,g,bq,d)
    kr = k.reshape(b, nkv, bkv, kvh, d).permute(1, 0, 3, 2, 4)      # (nkv,b,kv,bkv,d)
    vr = v.reshape(b, nkv, bkv, kvh, d).permute(1, 0, 3, 2, 4)
    ar_q = torch.arange(bq, device=dev)
    ar_kv = torch.arange(bkv, device=dev)

    outs = []
    for qi in range(nq):
        qb = qr[qi]                                        # (b, kv, g, bq, d)
        q_pos = qi * bq + ar_q + q_offset
        m = torch.full((b, kvh, g, bq), -1e30, dtype=f32, device=dev)
        l = torch.zeros((b, kvh, g, bq), dtype=f32, device=dev)
        acc = torch.zeros((b, kvh, g, bq, d), dtype=f32, device=dev)
        for ki in range(nkv):
            kb, vb = kr[ki], vr[ki]
            k_pos = ki * bkv + ar_kv
            logits = torch.einsum("bkgqd,bktd->bkgqt", qb, kb).to(f32)
            logits = logits * scale
            mask = k_pos[None, :] <= q_pos[:, None]
            if pad_kv:
                mask &= k_pos[None, :] < skv_real
            if window is not None:
                mask &= k_pos[None, :] > q_pos[:, None] - window
            logits = torch.where(mask, logits, -1e30)
            m_new = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,bktd->bkgqd", p.to(vb.dtype), vb).to(f32)
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.to(q.dtype))
    out = torch.stack(outs)                                # (nq,b,kv,g,bq,d)
    return out.permute(1, 0, 4, 2, 3, 5).reshape(b, sq, h, d)[:, :sq_real]


def _attend_flash_blocks(q, k, v, cfg: ModelConfig, q_offset: int = 0
                         ) -> torch.Tensor:
    """Flash attention over ONLY the (q, kv) tile pairs that the causal /
    sliding-window structure leaves non-empty, in three classes — full
    tiles (no mask), diagonal tiles and window-edge tiles (one shared mask
    each) — processed class by class, as the JAX package's scans do.  The
    products accumulate in float32 (its ``preferred_element_type``).
    Self-attention only (Sq == Skv, no offset)."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if sq != skv or q_offset != 0:
        raise ValueError("the block-skip path is for self-attention")
    kvh = cfg.n_kv_heads
    g = h // kvh
    bs = min(FLASH_BLOCK_Q, sq)
    # Padded key columns only appear in diagonal tiles, where the causal
    # mask already excludes them for the real query rows.
    sq_real = sq
    pad = (-sq) % bs
    q, k, v = _pad_seq(q, pad), _pad_seq(k, pad), _pad_seq(v, pad)
    sq += pad
    nq = sq // bs
    scale = d ** -0.5
    w = cfg.swa_window
    f32 = torch.float32
    dev = q.device

    qr = q.reshape(b, nq, bs, kvh, g, d).permute(1, 0, 3, 4, 2, 5)
    kr = k.reshape(b, nq, bs, kvh, d).permute(1, 0, 3, 2, 4)
    vr = v.reshape(b, nq, bs, kvh, d).permute(1, 0, 3, 2, 4)

    full, diag, edges = [], [], {}
    for qi in range(nq):
        for ki in range(qi + 1):
            r = qi - ki
            if w is not None and r * bs >= w + bs - 1:
                continue                       # wholly outside the window
            if r == 0:
                diag.append((qi, ki))
            elif w is not None and (r + 1) * bs > w:
                edges.setdefault(r, []).append((qi, ki))
            else:
                full.append((qi, ki))

    ii = torch.arange(bs, device=dev)[:, None]
    jj = torch.arange(bs, device=dev)[None, :]
    diag_mask = ii >= jj
    if w is not None:
        diag_mask &= (ii - jj) < w

    m = [torch.full((b, kvh, g, bs), -1e30, dtype=f32, device=dev)
         for _ in range(nq)]
    l = [torch.zeros((b, kvh, g, bs), dtype=f32, device=dev)
         for _ in range(nq)]
    acc = [torch.zeros((b, kvh, g, bs, d), dtype=f32, device=dev)
           for _ in range(nq)]

    def run(pairs, mask):
        for qi, ki in pairs:
            vb = vr[ki]
            logits = torch.einsum("bkgqd,bktd->bkgqt", qr[qi].to(f32),
                                  kr[ki].to(f32)) * scale
            if mask is not None:
                logits = torch.where(mask, logits, -1e30)
            m_new = torch.maximum(m[qi], logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m[qi] - m_new)
            l[qi] = l[qi] * corr + p.sum(-1)
            acc[qi] = acc[qi] * corr[..., None] + torch.einsum(
                "bkgqt,bktd->bkgqd", p.to(vb.dtype).to(f32), vb.to(f32))
            m[qi] = m_new

    run(full, None)
    run(diag, diag_mask)
    for r, pairs in edges.items():
        run(pairs, (r * bs + ii - jj) < w)
    out = torch.stack(acc) / torch.clamp_min(torch.stack(l), 1e-30)[..., None]
    return out.permute(1, 0, 4, 2, 3, 5).reshape(b, sq, h, d)[
        :, :sq_real].to(q.dtype)


def _flash(q, k, v, cfg: ModelConfig) -> torch.Tensor:
    if FLASH_BLOCK_SKIP and q.shape[1] == k.shape[1]:
        return _attend_flash_blocks(q, k, v, cfg)
    return _attend_flash(q, k, v, cfg)


def _self_attend(q, k, v, cfg: ModelConfig) -> torch.Tensor:
    """Causal self-attention over a whole sequence: flash above
    ``FLASH_THRESHOLD`` tokens, the dense softmax up to it."""
    s = q.shape[1]
    if s > FLASH_THRESHOLD:
        return _flash(q, k, v, cfg)
    return _attend(q, k, v, _causal_mask(s, s, 0, cfg.swa_window, q.device),
                   cfg)


# --------------------------------------------------------------------------
# Training: full-sequence causal attention, no cache
# --------------------------------------------------------------------------
def apply_train(params, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, key=None) -> torch.Tensor:
    """Full-sequence causal (optionally sliding-window) attention through
    the grouped ``attn.qkv`` launch; x (B, S, d), positions (B, S)."""
    q, k, v = _qkv(params, x, cfg, key)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    out = _self_attend(q, k, v, cfg)
    return common.dense_tp_reduce(params["wo"], _merge_heads(out),
                                  cfg.site_tdvmm("attn.out"), key)


# --------------------------------------------------------------------------
# Dense cache (calibration pass and the solo greedy oracle)
# --------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device) -> KVCache:
    """A (batch, size) cache; size = min(max_len, window) for a sliding
    window (a ring), else max_len.  int8 codes and float32 scales under
    ``set_kv_cache_int8(True)``."""
    size = max_len if cfg.swa_window is None else min(max_len, cfg.swa_window)
    shape = (batch, size, cfg.n_kv_heads, cfg.resolved_head_dim)
    pos = torch.zeros((batch,), dtype=torch.int32, device=device)
    if KV_CACHE_INT8:
        return KVCache(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(shape, dtype=torch.int8, device=device),
                       pos,
                       torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device),
                       torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device))
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), pos)


def apply_prefill(params, x: torch.Tensor, cfg: ModelConfig, cache: KVCache,
                  key=None) -> tuple[torch.Tensor, KVCache]:
    """Process a full prompt, filling the cache in place (cache.pos == 0).
    A sliding-window ring shorter than the prompt keeps its last ``size``
    tokens, rolled so that position p sits at slot p % size.  Attention
    runs over the full-precision keys and values; an int8 cache stores
    their codes and scales."""
    b, s, _ = x.shape
    size = cache.k.shape[1]
    if s > size and cfg.swa_window is None:
        raise ValueError(f"prompt of {s} tokens exceeds the cache ({size})")
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    q, k, v = _qkv(params, x, cfg, key)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    out = _self_attend(q, k, v, cfg)
    stores = [(cache.k, k), (cache.v, v)]
    if cache.k_scale is not None:
        (k_q, k_s), (v_q, v_s) = _kv_quantize(k), _kv_quantize(v)
        stores = [(cache.k, k_q), (cache.v, v_q), (cache.k_scale, k_s),
                  (cache.v_scale, v_s)]
    for buf, val in stores:
        if size >= s:
            buf[:, :s] = val.to(buf.dtype)
        else:
            buf.copy_(torch.roll(val[:, -size:], s % size, dims=1))
    pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    y = common.dense(params["wo"], _merge_heads(out),
                     cfg.site_tdvmm("attn.out"), key, tp="row")
    return y, cache._replace(pos=pos)


def _read(cache, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """A dense cache's keys and values in the compute dtype."""
    if cache.k_scale is not None:
        return (_kv_dequantize(cache.k, cache.k_scale, dtype),
                _kv_dequantize(cache.v, cache.v_scale, dtype))
    return cache.k.to(dtype), cache.v.to(dtype)


def _write(cache, idx: tuple, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write one (...)-indexed set of positions of a dense cache or page
    pool in place: the keys and values, or their int8 codes and scales."""
    if cache.k_scale is not None:
        (k, k_s), (v, v_s) = _kv_quantize(k), _kv_quantize(v)
        cache.k_scale[idx] = k_s
        cache.v_scale[idx] = v_s
    cache.k[idx] = k.to(cache.k.dtype)
    cache.v[idx] = v.to(cache.v.dtype)


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
    _write(cache, (rows, slot), k[:, 0], v[:, 0])
    kpos = torch.arange(size, device=x.device)
    if swa:
        age = (slot[:, None] - kpos[None, :]) % size
        valid = age <= torch.clamp(pos, max=size - 1)[:, None]
    else:
        valid = kpos[None, :] <= pos[:, None]
    mask = valid[:, None, None, :]                               # (B, 1, 1, S)
    k_read, v_read = _read(cache, q.dtype)
    out = _attend(q, k_read, v_read, mask, cfg)
    y = common.dense(params["wo"], _merge_heads(out),
                     cfg.site_tdvmm("attn.out"), key, tp="row")
    return y, cache._replace(pos=pos + 1)


# --------------------------------------------------------------------------
# Paged KV cache (serving engine): block-table-indexed pages.  See
# runtime/paged_cache.py for the layout and the trash-page convention.
# --------------------------------------------------------------------------
def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     dtype, device) -> PagedKVCache:
    """One attention layer's page pool (+1 trash page), int8 codes and
    float32 scales under ``set_kv_cache_int8(True)``."""
    if cfg.swa_window is not None:
        raise NotImplementedError(
            "the paged cache does not hold sliding-window attention (nor does "
            "the JAX package's); serve such models through the static path")
    shape = (num_pages + 1, page_size, cfg.n_kv_heads, cfg.resolved_head_dim)
    if KV_CACHE_INT8:
        return PagedKVCache(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    return PagedKVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device))


def _paged_read(cache: PagedKVCache, tables: torch.Tensor, dtype):
    """Gather a slot's pages into position order.  tables: (..., P) page ids
    -> k/v (..., P*page_size, n_kv, head_dim) in the compute dtype."""
    idx = tables.long()
    k_read = cache.k[idx]                        # (..., P, ps, kv, hd)
    v_read = cache.v[idx]
    flat = k_read.shape[:-4] + (-1,) + k_read.shape[-2:]
    k_read, v_read = k_read.reshape(flat), v_read.reshape(flat)
    if cache.k_scale is not None:
        ks = cache.k_scale[idx].reshape(flat[:-1])
        vs = cache.v_scale[idx].reshape(flat[:-1])
        return (_kv_dequantize(k_read, ks, dtype),
                _kv_dequantize(v_read, vs, dtype))
    return k_read.to(dtype), v_read.to(dtype)


def apply_prefill_paged(params, x: torch.Tensor, cfg: ModelConfig,
                        cache: PagedKVCache, ctx, key=None
                        ) -> tuple[torch.Tensor, PagedKVCache]:
    """One fixed-size prefill chunk for ONE slot.  x: (1, C, d); ctx:
    ``runtime.paged_cache.PrefillChunkCtx``.

    Tokens [offset, offset + valid) are projected, rope'd at their global
    positions, written in place into the slot's pages through the block-table
    row, and attended against every page the slot owns (read back as
    written: dequantized in int8 mode) under the global causal mask.  Padded
    rows (>= valid) write to the trash page and their outputs are garbage
    the engine drops."""
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
    _write(cache, (pid, off), k[0], v[0])

    k_read, v_read = _paged_read(cache, ctx.block_row[None], q.dtype)
    kpos = torch.arange(n_rows * ps, dtype=torch.int32, device=x.device)
    mask = (kpos[None, :] <= gpos[:, None]) \
        & (kpos[None, :] < ctx.offset + ctx.valid)
    out = _attend(q, k_read, v_read, mask[None, None], cfg)
    y = common.dense(params["wo"], _merge_heads(out),
                     cfg.site_tdvmm("attn.out"), key, tp="row")
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
    _write(cache, (pid, off), k[:, 0], v[:, 0])

    k_read, v_read = _paged_read(cache, ctx.block_tables, q.dtype)
    kpos = torch.arange(n_rows * ps, dtype=torch.int32, device=x.device)
    mask = (kpos[None, :] <= pos[:, None])[:, None, None, :]  # (B,1,1,cap)
    out = _attend(q, k_read, v_read, mask, cfg)
    y = common.dense(params["wo"], _merge_heads(out),
                     cfg.site_tdvmm("attn.out"), key, tp="row")
    return y, cache
