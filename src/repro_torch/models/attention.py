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

Under a mesh's ``model`` axis attention runs on its shard (the config of
``meshctx.local_config``), split in one of three modes
(``meshctx.attn_split``), or kept whole on every rank where none applies:

* "heads": the heads and KV heads divided, each rank its contiguous heads;
* "lanes", the head-dim fallback: every head kept with ``head_dim / tp`` of
  its lanes (whole rotary pairs, ``meshctx.lane_index``); scores are
  partial dot products summed over ``model`` (``_qk``), the softmax is
  replicated, ``softmax . v`` stays on the rank's lanes (``_pv``), ``wo``'s
  rows are the (head, lane) rows, and an int8 cache's per-(token, head)
  scale is a max over every rank's lanes;
* "groups", where the heads divide and the ranks divide into the KV
  heads' groups: a rank holds its contiguous query heads and the one KV
  head they read (``wk`` / ``wv``'s columns of that head, replicated on
  the ranks of its KV group, and one head of the cache); the projections
  are column-parallel and ``wo`` row-parallel as under "heads", with no
  score all-reduce, and an int8 cache's scales are the rank's own.  Each
  copy of a KV head's weight gets only its own query heads' gradient: the
  training step sums it over the KV group (``meshctx.kv_group_sum``).
With ``meshctx.split_seq`` on (a batch the data axes do not divide) each
data rank's dense cache holds a contiguous segment of the sequence: a
prefill writes the positions its rank owns (its attention runs whole: the
prompt's keys are on every rank), and a decode step attends each rank's
segment and combines the ranks: the softmax's max and sum over every
rank's keys, then the ranks' float32 partial products
(``_attend_split``).

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
from repro_torch.launch import meshctx
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


def _kv_quantize(x: torch.Tensor, lanes: bool = False
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) -> int8 codes + per-(token, head) float32 scale, computed in
    x's dtype as the JAX package does.  ``lanes``: x holds this rank's
    lanes of each head (the head-dim fallback), and the max is taken over
    every rank's, so the codes are the meshless codes' lanes."""
    amax = torch.amax(torch.abs(x), dim=-1)
    if lanes:
        amax = meshctx.tp_max(amax)
    scale = torch.clamp_min(amax, 1e-6) / 127.0
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


def _lanes(cfg: ModelConfig) -> bool:
    """This shard holds lanes of every head (the head-dim fallback)."""
    return cfg.attn_split == "lanes" and cfg.tp_shards > 1


def _groups(cfg: ModelConfig) -> bool:
    """This shard holds its query heads and their one KV head (the KV
    groups split)."""
    return cfg.attn_split == "groups" and cfg.tp_shards > 1


def _tp(cfg: ModelConfig) -> Optional[str]:
    """The projections' tensor-parallel kind: replicated (None) where
    attention is kept whole on every model rank."""
    return None if cfg.attn_split == "whole" and cfg.tp_shards > 1 else "col"


def _lane_rows(heads: int, cfg: ModelConfig) -> Optional[torch.Tensor]:
    """Under the head-dim fallback, this rank's columns of a (d, heads x
    head_dim) projection within the whole one (``meshctx.lane_index``)."""
    if not _lanes(cfg):
        return None
    hd = cfg.head_dim * cfg.tp_shards
    lanes = meshctx.lane_index(hd, cfg.tp_shards, meshctx.tp_rank())
    return (torch.arange(heads)[:, None] * hd + lanes).reshape(-1)


def _qkv(params, x: torch.Tensor, cfg: ModelConfig, key=None):
    """q/k/v projections as one grouped site (``attn.qkv``)."""
    td = cfg.site_tdvmm("attn.qkv")
    hd = cfg.resolved_head_dim
    shard = replicas = None
    if _lanes(cfg):
        shard = (_lane_rows(cfg.n_heads, cfg),
                 _lane_rows(cfg.n_kv_heads, cfg),
                 _lane_rows(cfg.n_kv_heads, cfg))
    elif _groups(cfg):
        h = meshctx.kv_head(cfg.tp_shards, cfg.tp_kv_heads,
                            meshctx.tp_rank())
        cols = torch.arange(h * hd, (h + 1) * hd)
        shard = (None, cols, cols)
        size = cfg.tp_shards // cfg.tp_kv_heads
        replicas = (1, size, size)
    q, k, v = common.dense_group(
        (params["wq"], params["wk"], params["wv"]), x, td, key,
        tp=_tp(cfg), shard=shard, replicas=replicas)
    return (_split_heads(q, cfg.n_heads, hd),
            _split_heads(k, cfg.n_kv_heads, hd),
            _split_heads(v, cfg.n_kv_heads, hd))


def _out(params, out: torch.Tensor, cfg: ModelConfig, key=None):
    """``wo`` (site ``attn.out``), row-parallel over ``model``."""
    return common.dense(params["wo"], _merge_heads(out),
                        cfg.site_tdvmm("attn.out"), key,
                        tp=None if _tp(cfg) is None else "row",
                        shard=_lane_rows(cfg.n_heads, cfg))


def _rope(x: torch.Tensor, positions: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    """Rotary embedding; under the head-dim fallback with the frequencies
    of this rank's lanes of the whole head."""
    if not _lanes(cfg):
        return common.apply_rope(x, positions, cfg.rope_theta)
    n = cfg.tp_shards
    freqs = common.rope_freqs(cfg.head_dim * n, cfg.rope_theta, x.device)
    q, r = cfg.head_dim // 2, meshctx.tp_rank()
    return common.apply_rope(x, positions, cfg.rope_theta,
                             freqs=freqs[r * q:(r + 1) * q])


def _scale(cfg: ModelConfig, d: int) -> float:
    """The softmax scale 1 / sqrt(head_dim) of the whole head."""
    return (d * (cfg.tp_shards if _lanes(cfg) else 1)) ** -0.5


def _qk(eq: str, q: torch.Tensor, k: torch.Tensor, cfg: ModelConfig,
        f32: bool = False) -> torch.Tensor:
    """Float32 scores ``einsum(eq, q, k)``: rounded to q's dtype as the
    meshless product is (``f32``: float32 operands, unrounded).  Under the
    head-dim fallback each rank's float32 partial dot products summed over
    ``model`` (then rounded the same way)."""
    if not _lanes(cfg):
        if f32:
            return torch.einsum(eq, q.to(torch.float32), k.to(torch.float32))
        return torch.einsum(eq, q, k).to(torch.float32)
    part = torch.einsum(eq, q.to(torch.float32), k.to(torch.float32))
    s = meshctx.reduce_from_tp(part)
    return s if f32 else s.to(q.dtype).to(torch.float32)


def _pv(eq: str, p: torch.Tensor, v: torch.Tensor,
        cfg: ModelConfig) -> torch.Tensor:
    """``einsum(eq, p, v)``: under the head-dim fallback on this rank's
    lanes of v, the replicated probabilities entering as a column-parallel
    input (their gradient summed over ``model``)."""
    if _lanes(cfg):
        p = meshctx.copy_to_tp(p)
    return torch.einsum(eq, p, v)


def _attend(q, k, v, mask, cfg: ModelConfig) -> torch.Tensor:
    """q: (B,Sq,H,D); k,v: (B,Skv,Kv,D); mask: (B,1,Sq,Skv) or broadcastable."""
    hd = q.shape[-1]
    groups = cfg.n_heads // cfg.n_kv_heads
    b, sq, h, _ = q.shape
    q = q.reshape(b, sq, cfg.n_kv_heads, groups, hd)
    logits = _qk("bskgd,btkd->bkgst", q, k, cfg)
    logits = logits * _scale(cfg, hd)
    logits = torch.where(mask[:, :, None] if mask.dim() == 4 else mask,
                         logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = _pv("bkgst,btkd->bskgd", probs, v, cfg)
    return out.reshape(b, sq, h, hd)


SEQ_ORDER = 1   # > 1: meshless decode attention in a sequence split's order


def _attend_split(q, k, v, mask, cfg: ModelConfig,
                  parts: int = 1) -> torch.Tensor:
    """``_attend`` over this data rank's segment of a sequence-split cache:
    the softmax's max and sum taken over every rank's keys (two
    all-reduces over the data axes), each rank's share of probabilities x
    values as float32 partial products, summed over the data axes and
    rounded once, as the meshless product rounds its one accumulator.
    Meshless with ``parts`` n (``SEQ_ORDER``, ``chip_smoke.seq_order``):
    the same arithmetic over n contiguous segments of the cache, added in
    segment order, which an n x 1 run reproduces bit for bit."""
    hd = q.shape[-1]
    groups = cfg.n_heads // cfg.n_kv_heads
    b, sq, h, _ = q.shape
    kv = cfg.n_kv_heads
    q = q.reshape(b, sq, kv, groups, hd)
    if mask.dim() == 4:
        mask = mask[:, :, None]
    logits = [torch.where(m, _qk("bskgd,btkd->bkgst", q, kp, cfg)
                          * _scale(cfg, hd), -1e30)
              for kp, m in zip(k.chunk(parts, 1),
                               mask.expand(mask.shape[:-1] + (k.shape[1],))
                               .chunk(parts, -1))]
    top = logits[0].amax(-1)
    for lg in logits[1:]:
        top = torch.maximum(top, lg.amax(-1))
    top = meshctx.dp_max(top)
    es = [torch.exp(lg - top[..., None]) for lg in logits]
    total = es[0].sum(-1)
    for e in es[1:]:
        total = total + e.sum(-1)
    total = meshctx.dp_sum(total)
    out = None
    for e, vp in zip(es, v.chunk(parts, 1)):
        t = vp.shape[1]
        part = common.partial_f32(
            (e / total[..., None]).to(v.dtype).reshape(b * kv, groups * sq, t),
            vp.permute(0, 2, 1, 3).reshape(b * kv, t, hd))
        out = part if out is None else out + part
    out = meshctx.dp_sum(out).to(v.dtype)
    return out.reshape(b, kv, groups, sq, hd).permute(0, 3, 1, 2, 4).reshape(
        b, sq, h, hd)


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
    scale = _scale(cfg, d)
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
            logits = _qk("bkgqd,bktd->bkgqt", qb, kb, cfg)
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
            acc = acc * corr[..., None] + _pv(
                "bkgqt,bktd->bkgqd", p.to(vb.dtype), vb, cfg).to(f32)
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
    scale = _scale(cfg, d)
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
            logits = _qk("bkgqd,bktd->bkgqt", qr[qi], kr[ki], cfg,
                         f32=True) * scale
            if mask is not None:
                logits = torch.where(mask, logits, -1e30)
            m_new = torch.maximum(m[qi], logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m[qi] - m_new)
            l[qi] = l[qi] * corr + p.sum(-1)
            acc[qi] = acc[qi] * corr[..., None] + _pv(
                "bkgqt,bktd->bkgqd", p.to(vb.dtype).to(f32), vb.to(f32), cfg)
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
    q = _rope(q, positions, cfg)
    k = _rope(k, positions, cfg)
    out = _self_attend(q, k, v, cfg)
    if _tp(cfg) is None:
        return common.dense(params["wo"], _merge_heads(out),
                            cfg.site_tdvmm("attn.out"), key, tp=None)
    return common.dense_tp_reduce(params["wo"], _merge_heads(out),
                                  cfg.site_tdvmm("attn.out"), key,
                                  shard=_lane_rows(cfg.n_heads, cfg))


# --------------------------------------------------------------------------
# Dense cache (calibration pass and the solo greedy oracle)
# --------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device) -> KVCache:
    """A (batch, size) cache; size = min(max_len, window) for a sliding
    window (a ring), else max_len.  int8 codes and float32 scales under
    ``set_kv_cache_int8(True)``.  Under ``meshctx.split_seq`` this data
    rank's contiguous segment: size / (data ranks) slots."""
    size = max_len if cfg.swa_window is None else min(max_len, cfg.swa_window)
    if meshctx.seq_split():
        n = meshctx.dp_size()
        if size % n:
            raise ValueError(f"a cache of {size} positions does not split "
                             f"over {n} data ranks")
        size //= n
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


def _segment(cache) -> tuple[int, int]:
    """(first slot, whole size) of this rank's dense cache: (0, its size),
    or under ``meshctx.split_seq`` its segment of the whole."""
    size = cache.k.shape[1]
    if not meshctx.seq_split():
        return 0, size
    return meshctx.dp_rank() * size, size * meshctx.dp_size()


def apply_prefill(params, x: torch.Tensor, cfg: ModelConfig, cache: KVCache,
                  key=None) -> tuple[torch.Tensor, KVCache]:
    """Process a full prompt, filling the cache in place (cache.pos == 0).
    A sliding-window ring shorter than the prompt keeps its last ``size``
    tokens, rolled so that position p sits at slot p % size.  Attention
    runs over the full-precision keys and values; an int8 cache stores
    their codes and scales.  Sequence-split (``meshctx.split_seq``), each
    rank stores its segment of the positions (or of the ring's slots);
    its batch, and so every key of the prompt, is whole on every rank, so
    the prompt's attention runs whole, the meshless bits."""
    b, s, _ = x.shape
    seg0, size = _segment(cache)
    mine = cache.k.shape[1]
    if s > size and cfg.swa_window is None:
        raise ValueError(f"prompt of {s} tokens exceeds the cache ({size})")
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    q, k, v = _qkv(params, x, cfg, key)
    q = _rope(q, positions, cfg)
    k = _rope(k, positions, cfg)
    out = _self_attend(q, k, v, cfg)
    stores = [(cache.k, k), (cache.v, v)]
    if cache.k_scale is not None:
        lanes = _lanes(cfg)
        (k_q, k_s), (v_q, v_s) = _kv_quantize(k, lanes), _kv_quantize(v, lanes)
        stores = [(cache.k, k_q), (cache.v, v_q), (cache.k_scale, k_s),
                  (cache.v_scale, v_s)]
    for buf, val in stores:
        if size >= s:
            hi = min(max(s - seg0, 0), mine)
            buf[:, :hi] = val[:, seg0:seg0 + hi].to(buf.dtype)
        else:
            ring = torch.roll(val[:, -size:], s % size, dims=1)
            buf.copy_(ring[:, seg0:seg0 + mine])
    pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return _out(params, out, cfg, key), cache._replace(pos=pos)


def _read(cache, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """A dense cache's keys and values in the compute dtype."""
    if cache.k_scale is not None:
        return (_kv_dequantize(cache.k, cache.k_scale, dtype),
                _kv_dequantize(cache.v, cache.v_scale, dtype))
    return cache.k.to(dtype), cache.v.to(dtype)


def _write(cache, idx: tuple, k: torch.Tensor, v: torch.Tensor,
           lanes: bool = False, keep: Optional[torch.Tensor] = None) -> None:
    """Write one (...)-indexed set of positions of a dense cache or page
    pool in place: the keys and values, or their int8 codes and scales
    (``lanes`` as ``_kv_quantize``'s).  ``keep``: (rows,) True where the
    row's slot is not this rank's (a sequence-split cache), whose old
    contents stay."""
    if cache.k_scale is not None:
        (k, k_s), (v, v_s) = _kv_quantize(k, lanes), _kv_quantize(v, lanes)
        _put(cache.k_scale, idx, k_s, keep)
        _put(cache.v_scale, idx, v_s, keep)
    _put(cache.k, idx, k.to(cache.k.dtype), keep)
    _put(cache.v, idx, v.to(cache.v.dtype), keep)


def _put(buf: torch.Tensor, idx: tuple, val: torch.Tensor,
         keep: Optional[torch.Tensor]) -> None:
    if keep is not None:
        old = buf[idx]
        val = torch.where(keep.reshape((-1,) + (1,) * (val.dim() - 1)),
                          old, val)
    buf[idx] = val


def _capacity_check(pos: torch.Tensor, size: int) -> None:
    """Raise when a full (non-ring) cache would be written past its end;
    skipped for fake tensors (the dry run), whose values are unknown."""
    from torch._subclasses.fake_tensor import is_fake
    if not is_fake(pos) and bool(torch.any(pos >= size)):
        raise ValueError(
            f"attention.apply_decode: KV cache capacity exceeded "
            f"(pos={pos.tolist()} >= size={size})")


def apply_decode(params, x: torch.Tensor, cfg: ModelConfig, cache: KVCache,
                 key=None) -> tuple[torch.Tensor, KVCache]:
    """One-token decode step, x: (B, 1, d); writes the cache in place.
    A sliding-window ring writes slot pos % size and attends to the slots
    written within the last ``size`` steps; a full cache raises when
    decoding past its capacity.  Sequence-split (``meshctx.split_seq``),
    the rank that owns the slot writes it, and every rank's partial
    softmax over its segment is combined over the data axes."""
    b = x.shape[0]
    pos = cache.pos
    seg0, size = _segment(cache)
    mine = cache.k.shape[1]
    swa = cfg.swa_window is not None
    if not swa:
        _capacity_check(pos, size)
    q, k, v = _qkv(params, x, cfg, key)
    q = _rope(q, pos[:, None], cfg)
    k = _rope(k, pos[:, None], cfg)
    rows = torch.arange(b, device=x.device)
    slot = (pos % size if swa else pos).long()
    keep = None
    if mine != size:
        local = slot - seg0
        keep = (local < 0) | (local >= mine)
        slot = local.clamp(0, mine - 1)
        seg = seg0 + torch.arange(mine, device=x.device)
    else:
        seg = torch.arange(size, device=x.device)
    _write(cache, (rows, slot), k[:, 0], v[:, 0], _lanes(cfg), keep)
    if swa:
        age = ((pos % size).long()[:, None] - seg[None, :]) % size
        valid = age <= torch.clamp(pos, max=size - 1)[:, None]
    else:
        valid = seg[None, :] <= pos[:, None]
    mask = valid[:, None, None, :]                               # (B, 1, 1, S)
    k_read, v_read = _read(cache, q.dtype)
    if mine != size:
        out = _attend_split(q, k_read, v_read, mask, cfg)
    elif SEQ_ORDER > 1:
        out = _attend_split(q, k_read, v_read, mask, cfg, SEQ_ORDER)
    else:
        out = _attend(q, k_read, v_read, mask, cfg)
    return _out(params, out, cfg, key), cache._replace(pos=pos + 1)


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
    q = _rope(q, gpos[None], cfg)
    k = _rope(k, gpos[None], cfg)

    pid = ctx.block_row[torch.clamp(gpos // ps, max=n_rows - 1).long()]
    pid = torch.where(ar < ctx.valid, pid, trash).long()     # (C,)
    off = (gpos % ps).long()
    _write(cache, (pid, off), k[0], v[0], _lanes(cfg))

    k_read, v_read = _paged_read(cache, ctx.block_row[None], q.dtype)
    kpos = torch.arange(n_rows * ps, dtype=torch.int32, device=x.device)
    mask = (kpos[None, :] <= gpos[:, None]) \
        & (kpos[None, :] < ctx.offset + ctx.valid)
    out = _attend(q, k_read, v_read, mask[None, None], cfg)
    return _out(params, out, cfg, key), cache


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
    q = _rope(q, pos[:, None], cfg)
    k = _rope(k, pos[:, None], cfg)

    page_idx = torch.clamp(pos // ps, max=n_rows - 1).long()
    pid = torch.gather(ctx.block_tables, 1, page_idx[:, None])[:, 0]
    pid = torch.where(ctx.active, pid, trash).long()         # (B,)
    off = (pos % ps).long()
    _write(cache, (pid, off), k[:, 0], v[:, 0], _lanes(cfg))

    k_read, v_read = _paged_read(cache, ctx.block_tables, q.dtype)
    kpos = torch.arange(n_rows * ps, dtype=torch.int32, device=x.device)
    mask = (kpos[None, :] <= pos[:, None])[:, None, None, :]  # (B,1,1,cap)
    out = _attend(q, k_read, v_read, mask, cfg)
    return _out(params, out, cfg, key), cache
