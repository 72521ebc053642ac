"""Parameter / state / batch / cache placements — torch port of
``repro.launch.sharding``.

The rules are the JAX package's, written as placements: a ``P`` holds one
entry per dim, None (replicated) or the mesh axes the dim is split over
(a name, or a tuple of names split row-major).

  * batch            -> all DP axes ('pod', 'data')
  * FSDP (ZeRO-3)    -> params' non-TP matrix dim over the DP axes
  * TP               -> heads / ffn-hidden / vocab dim over 'model'
  * MoE expert banks -> impl 'ep': expert dim over the DP axes, hidden over
                        'model'; impl 'local': replicated expert dim, FSDP
                        d, TP hidden

Rules match the TRAILING dims of each leaf, so a leaf with extra leading
dims gets None on the left.

Three placements of the port split a dim over ``model`` other than in
contiguous chunks (a ``Split`` entry, which is the axis name to every
other reader): the head-dim fallback's attention weights and caches
(``meshctx.lane_index``: each head's share of lanes, whole rotary pairs),
the KV groups split's ``wk`` / ``wv`` columns and KV caches (one KV head a
rank, the same head on every rank of its group) and the SSM's conv
channels (``meshctx.segment_index``: the x, B and C segments each
split).  The SSM's per-head leaves (``A_log``, ``D``,
``dt_bias``) and its gated norm's scale follow its heads and channels over
``model``, where the JAX package replicates them (each rank then holds the
slice it uses).

``shard_tree`` slices a full tree into this rank's shards and
``gather_tree`` all-gathers shards back into full leaves: both are exact
copies, and they take the place of ``to_named`` / ``device_put``.
"""
from __future__ import annotations

import re
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import meshctx
from repro_torch.launch.mesh import axis_info
from repro_torch.tree import leaves_with_paths, tree_map


class P:
    """A placement: one entry per dim (None, an axis name, or a tuple of
    axis names).  Not a tuple, so the port's tree functions take it as a
    leaf."""
    __slots__ = ("dims",)

    def __init__(self, *dims):
        self.dims = tuple(None if d is None or d == () else d for d in dims)

    def __iter__(self):
        return iter(self.dims)

    def __len__(self):
        return len(self.dims)

    def __getitem__(self, i):
        return self.dims[i]

    def __eq__(self, other):
        return isinstance(other, P) and self.dims == other.dims

    def __hash__(self):
        return hash(self.dims)

    def __repr__(self):
        return f"P{self.dims!r}"


class Split(str):
    """A placement entry that splits its dim over axis ``self`` (a str:
    every other reader takes it as the axis name) in a layout other than
    contiguous chunks: ``kind`` "lanes" (``layout`` = (heads, head_dim):
    ``meshctx.lane_index`` of every head), "groups" (``layout`` = (KV
    heads, head_dim): rank r holds KV head ``meshctx.kv_head``'s columns,
    so a rank's shard is one head wide and the ranks of a KV group hold
    the same columns) or "segments" (``layout`` = the segment sizes:
    ``meshctx.segment_index``)."""

    def __new__(cls, axis: str, kind: str, layout):
        out = str.__new__(cls, axis)
        out.kind, out.layout = kind, tuple(int(v) for v in layout)
        return out

    def __getnewargs__(self):
        return (str(self), self.kind, self.layout)

    def __repr__(self):
        return f"Split({str(self)!r}, {self.kind!r}, {self.layout})"

    def copies(self, n: int) -> int:
        """How many of ``n`` ranks hold each index ("groups": the ranks of
        a KV group; else 1)."""
        return n // self.layout[0] if self.kind == "groups" else 1

    def local(self, size: int, n: int) -> int:
        """The size of one rank's shard of a dim of ``size`` over ``n``."""
        if self.kind == "groups":
            heads, hd = self.layout
            if heads * hd != size or n % heads:
                raise ValueError(f"{self!r} on a dim of {size} over {n}")
            return hd
        if size % n:
            raise ValueError(f"dim of {size} does not split {n} ways "
                             f"({self!r})")
        return size // n

    def index(self, size: int, n: int, r: int) -> torch.Tensor:
        """Rank ``r`` of ``n``'s indices along a dim of ``size``."""
        if self.kind == "groups":
            hd = self.local(size, n)
            h = meshctx.kv_head(n, self.layout[0], r)
            return torch.arange(h * hd, (h + 1) * hd)
        if self.kind == "lanes":
            heads, hd = self.layout
            if heads * hd != size:
                raise ValueError(f"{self!r} on a dim of {size}")
            lanes = meshctx.lane_index(hd, n, r)
            return (torch.arange(heads)[:, None] * hd + lanes).reshape(-1)
        if sum(self.layout) != size:
            raise ValueError(f"{self!r} on a dim of {size}")
        return meshctx.segment_index(self.layout, n, r)


def groups_entry(spec):
    """The KV groups split's entry of a placement, or None."""
    return next((ax for ax in (spec or ()) if isinstance(ax, Split)
                 and ax.kind == "groups"), None)


def _rules(fsdp, tp, ep):
    """(regex over '/'-joined path) -> trailing-dims placement entries."""
    return [
        # MoE expert banks (3D: E, d_in, d_out)
        (r"moe/experts/w_(up|gate)$", (ep, None, tp)),
        (r"moe/experts/w_down$", (ep, tp, None)),
        (r"moe/shared/w_(up|gate)$", (None, fsdp, tp)),
        (r"moe/shared/w_down$", (None, tp, fsdp)),
        (r"moe/router/w$", (None, None)),
        # attention
        (r"attn/w[qkv]/w$", (fsdp, tp)),
        (r"attn/w[qkv]/b$", (tp,)),
        (r"attn/wo/w$", (tp, fsdp)),
        (r"attn/wo/b$", (None,)),
        # ffn
        (r"ffn/w_(up|gate)/w$", (fsdp, tp)),
        (r"ffn/w_down/w$", (tp, fsdp)),
        # ssm
        (r"ssm/w[zx]/w$", (fsdp, tp)),
        (r"ssm/w[BC]/w$", (fsdp, tp)),
        (r"ssm/wdt/w$", (fsdp, tp)),
        (r"ssm/wo/w$", (tp, fsdp)),
        (r"ssm/conv_w$", (None, None, tp)),
        (r"ssm/conv_b$", (tp,)),
        (r"ssm/(A_log|D|dt_bias)$", (tp,)),
        (r"ssm/norm/scale$", (tp,)),
        # embeddings / head / fuse
        (r"embed/table$", (tp, fsdp)),
        (r"head/w$", (fsdp, tp)),
        (r"fuse/w$", (fsdp, tp)),
        # norms and everything 1D
        (r"(scale|b)$", (None,)),
    ]


def _shape(leaf) -> tuple:
    return tuple(leaf.shape)


def param_specs(params: Any, cfg: ModelConfig, mesh,
                dp_axes: tuple[str, ...] | None = None,
                ep_axes: tuple[str, ...] | None = None):
    """Placement tree matching the params tree.

    dp_axes: override the FSDP axes (the serving engine passes () to
    replicate weights over DP — no ZeRO-3 gathers in the step).
    ep_axes: override the expert-bank axes independently of FSDP (serving
    keeps dense weights DP-replicated but still shards expert tables over
    the DP axes under ``moe.impl='ep'``).  (The JAX package's
    ``layer_axis``, a stacked layer dim over 'pod', has no counterpart:
    the port keeps one dict per layer, and ``launch.pipeline`` splits the
    list.)"""
    info = axis_info(mesh)
    fsdp = (info["dp_axes"] if dp_axes is None else dp_axes) or None
    tp = info["tp_axis"]
    ep_base = fsdp if ep_axes is None else (ep_axes or None)
    ep = ep_base if (cfg.moe is not None and cfg.moe.impl == "ep") else None
    rules = _rules(fsdp, tp, ep)
    specs = {}
    for path, leaf in leaves_with_paths(params):
        nd = len(_shape(leaf))
        spec = P(*((None,) * nd))
        for pat, trailing in rules:
            if re.search(pat, path):
                if len(trailing) > nd:
                    trailing = trailing[-nd:] if nd else ()
                spec = P(*((None,) * (nd - len(trailing)) + tuple(trailing)))
                break
        specs[path] = _layout(path, spec, cfg, tp, mesh)
    return _unflatten_paths(params, specs)


def _layout(path: str, spec: P, cfg: ModelConfig, tp, mesh) -> P:
    """``spec`` with its ``model`` entry made a ``Split`` (or dropped) where
    the leaf's ``model`` shard is not a contiguous chunk: attention under
    the head-dim fallback (lanes), ``wk`` / ``wv`` under the KV groups
    split (``wq``'s and ``wo``'s heads are contiguous chunks there), or
    attention kept whole; the SSM's conv channels."""
    n = meshctx.axis_size(tp, mesh) if tp else 1
    if n == 1:
        return spec
    entry = None
    if re.search(r"attn/w[qkv]/[wb]$|attn/wo/w$", path):
        mode = meshctx.attn_split(cfg, n)
        if mode == "whole":
            return P(*(None if d == tp else d for d in spec))
        if mode == "lanes":
            heads = cfg.n_kv_heads if re.search(r"attn/w[kv]/", path) \
                else cfg.n_heads
            entry = Split(tp, "lanes", (heads, cfg.resolved_head_dim))
        if mode == "groups" and re.search(r"attn/w[kv]/", path):
            entry = Split(tp, "groups",
                          (cfg.n_kv_heads, cfg.resolved_head_dim))
    elif re.search(r"ssm/conv_[wb]$", path):
        s = cfg.ssm
        gs = s.n_groups * s.d_state
        entry = Split(tp, "segments", (s.expand * cfg.d_model, gs, gs))
    if entry is None:
        return spec
    return P(*(entry if d == tp else d for d in spec))


def _unflatten_paths(tree, by_path: dict):
    paths = iter(p for p, _ in leaves_with_paths(tree))
    return tree_map(lambda _: by_path[next(paths)], tree)


def opt_state_specs(opt_state: Any, p_specs: Any):
    """Optimizer state shares its params' placement; Adafactor's factored
    moments drop the corresponding dim of the param's placement.  The
    port's ``OptState`` is (step, inner): AdamW's inner is {"m": params,
    "v": params}, Adafactor's one dict {"m", "vr", "vc"} or {"m", "v"} per
    param."""
    p_leaves = {p: s for p, s in leaves_with_paths(p_specs)}
    specs = {}
    for path, leaf in leaves_with_paths(opt_state):
        nd = len(_shape(leaf))
        spec = P(*((None,) * nd))
        m = re.match(r"inner/(m|v)/(.*)$", path)
        if m and m.group(2) in p_leaves:
            spec = p_leaves[m.group(2)]
        else:
            m = re.match(r"inner/(.*)/(m|vr|vc|v)$", path)
            if m and m.group(1) in p_leaves:
                base = tuple(p_leaves[m.group(1)])
                kind = m.group(2)
                if kind == "vr":
                    spec = P(*base[:-1])
                elif kind == "vc":
                    spec = P(*(base[:-2] + base[-1:]))
                else:
                    spec = P(*base)
        specs[path] = spec
    return _unflatten_paths(opt_state, specs)


def batch_specs(cfg: ModelConfig, mesh, kind: str, global_batch: int):
    dp = axis_info(mesh)["dp_axes"]
    if global_batch % meshctx.axis_size(dp, mesh) != 0:
        dp = None   # e.g. long_500k's batch=1: replicate batch
    inp = P(dp, None) if cfg.input_mode == "tokens" else P(dp, None, None)
    if kind in ("decode", "prefill"):
        return {"inputs": inp}
    return {"inputs": inp, "targets": P(dp, None)}


def cache_specs(caches: Any, cfg: ModelConfig, mesh):
    """KV caches: batch over DP and kv-heads over TP when divisible; falls
    back to sequence-sharding the cache (``meshctx.split_seq``), and to
    the head-dim fallback's lanes or the KV groups split's one head a rank
    (``meshctx.attn_split``), otherwise."""
    info = axis_info(mesh)
    dp, tp = info["dp_axes"], info["tp_axis"]
    dpn = meshctx.axis_size(dp, mesh)
    tpn = meshctx.axis_size(tp, mesh)
    dp = dp or None
    kv_ax, hd_ax = _head_axes(cfg, tp, tpn)

    def spec_for(s, shape):
        nd = len(shape)
        if s.endswith("/pos") or nd <= 1:
            return P(*((None,) * nd))
        if re.search(r"/(k|v)$", s):          # (L, B, S, KV, HD)
            L, B, S, KV, HD = shape
            b_ax = dp if B % dpn == 0 else None
            s_ax = dp if (b_ax is None and S % dpn == 0) else None
            return P(None, b_ax, s_ax, kv_ax, hd_ax)
        if re.search(r"/(k_scale|v_scale)$", s):   # (L, B, S, KV)
            L, B, S, KV = shape
            b_ax = dp if B % dpn == 0 else None
            s_ax = dp if (b_ax is None and S % dpn == 0) else None
            return P(None, b_ax, s_ax, kv_ax)
        if s.endswith("/conv"):               # (L, B, W, C)
            L, B, W, C = shape
            b_ax = dp if B % dpn == 0 else None
            c_ax = None
            if tpn > 1:
                gs = cfg.ssm.n_groups * cfg.ssm.d_state
                c_ax = Split(tp, "segments",
                             (cfg.ssm.expand * cfg.d_model, gs, gs))
            return P(None, b_ax, None, c_ax)
        if s.endswith("/state"):              # (L, B, H, P, S)
            L, B, H, Pp, S = shape
            b_ax = dp if B % dpn == 0 else None
            return P(None, b_ax, tp if H % tpn == 0 else None, None, None)
        return P(*((None,) * nd))

    return _unflatten_paths(caches, {
        p: spec_for("/" + p, _shape(t))
        for p, t in leaves_with_paths(caches)})


def _head_axes(cfg: ModelConfig, tp, tpn: int):
    """(KV-head entry, head-dim entry) of a KV cache's placement, as
    ``meshctx.attn_split`` splits attention."""
    if tpn == 1:
        return None, None
    mode = meshctx.attn_split(cfg, tpn)
    if mode == "heads":
        return tp, None
    if mode == "lanes":
        return None, Split(tp, "lanes", (1, cfg.resolved_head_dim))
    if mode == "groups":
        return Split(tp, "groups", (cfg.n_kv_heads, 1)), None
    return None, None


def paged_specs(caches: Any, cfg: ModelConfig, mesh):
    """Paged KV pools: head dims over TP, the page pool itself replicated
    (block tables index arbitrary page ids, so the page dim is never
    split; the DP slot-pool dim lives in the block tables).  kv-heads go
    over TP when divisible, else head_dim (the head-dim fallback) or one KV
    head a rank (the KV groups split).  Per-position int8 KV scales (L,
    pages, page_size, KV) follow their pool."""
    tp = axis_info(mesh)["tp_axis"]
    tpn = meshctx.axis_size(tp, mesh)
    kv_ax, hd_ax = _head_axes(cfg, tp, tpn)

    def spec_for(s, shape):
        nd = len(shape)
        if re.search(r"/(k|v)$", s):          # (L, pages, ps, KV, HD)
            return P(None, None, None, kv_ax, hd_ax)
        if re.search(r"/(k_scale|v_scale)$", s):   # (L, pages, ps, KV)
            return P(None, None, None, kv_ax)
        return P(*((None,) * nd))

    return _unflatten_paths(caches, {
        p: spec_for("/" + p, _shape(t))
        for p, t in leaves_with_paths(caches)})


def slot_specs(mesh, kind: str):
    """Engine step-batch layouts for the DP slot-pool dimension.

    decode: batch rows ARE the slots, ordered (dp_rank, local_slot), so the
    leading dim splits over DP — inputs/block_tables (B, ·), pos/active
    (B,).  prefill: one slot per step (batch 1) — fully replicated."""
    dp = axis_info(mesh)["dp_axes"] or None
    if kind == "prefill":
        return {"inputs": P(None, None), "block_row": P(None),
                "offset": P(), "valid": P()}
    if kind != "decode":
        raise ValueError(f"unknown engine step kind {kind!r}")
    return {"inputs": P(dp, None), "block_tables": P(dp, None),
            "pos": P(dp), "active": P(dp)}


# --------------------------------------------------------------------------
# Shards <-> full leaves
# --------------------------------------------------------------------------
def local_shape(shape: tuple, spec: P, mesh) -> tuple:
    """The shape of one rank's shard of a ``shape`` leaf placed by ``spec``."""
    out = []
    for n, ax in zip(shape, spec):
        k = meshctx.axis_size(ax, mesh) if ax is not None else 1
        if isinstance(ax, Split):
            out.append(ax.local(n, k))
            continue
        if n % k:
            raise ValueError(f"dim of {n} does not split {k} ways "
                             f"(placement {spec})")
        out.append(n // k)
    return tuple(out)


def shard(full: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's shard of a full (replicated) tensor: a contiguous copy."""
    t = full
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        k = meshctx.axis_size(ax, mesh)
        if not isinstance(ax, Split) and t.shape[dim] % k:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not "
                             f"split {k} ways (placement {spec})")
        r = meshctx.axis_rank(ax, mesh)
        if isinstance(ax, Split):
            t = t.index_select(dim, ax.index(t.shape[dim], k, r).to(
                t.device))
        else:
            t = t.chunk(k, dim=dim)[r]
    return t.contiguous().clone()


def gather(local: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The full tensor from every rank's shard (an all-gather per split
    dim, over that dim's axes; a KV head that several ranks hold is taken
    once, from the first of them).  Collective."""
    t = local
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        k = meshctx.axis_size(ax, mesh)
        if k > 1:
            t = meshctx.all_gather(t, meshctx.axes_group(ax, mesh), dim)
            if isinstance(ax, Split) and ax.kind == "groups":
                heads, w = ax.layout[0], t.shape[dim] // k
                t = torch.cat([t.narrow(dim, (h * k // heads) * w, w)
                               for h in range(heads)], dim)
            elif isinstance(ax, Split):
                n = t.shape[dim]
                where = torch.cat([ax.index(n, k, r) for r in range(k)])
                t = torch.empty_like(t).index_copy_(dim, where.to(t.device),
                                                    t)
    return t


def shard_tree(full: Any, specs: Any, mesh) -> Any:
    """This rank's shards of every leaf of ``full``."""
    return tree_map(lambda t, s: shard(t, s, mesh), full, specs)


def gather_tree(local: Any, specs: Any, mesh) -> Any:
    """Full leaves from every rank's shards.  Collective."""
    return tree_map(lambda t, s: gather(t, s, mesh), local, specs)


def regather(local: Any, have: Any, want: Any, mesh) -> Any:
    """Move shards from placement ``have`` to ``want`` where ``want``
    replicates what ``have`` splits (e.g. the FSDP dim of a training state
    to the compute layout): each such dim is all-gathered.  A dim ``want``
    splits must be split the same way in ``have``."""
    def one(t, h, w):
        for dim, (a, b) in enumerate(zip(h, w)):
            if a == b or a is None:
                if a != b:
                    raise ValueError(f"cannot split dim {dim} from {h} to {w}")
                continue
            if b is not None:
                raise ValueError(f"dim {dim}: {h} -> {w}")
            if meshctx.axis_size(a, mesh) > 1:
                t = meshctx.all_gather(t, meshctx.axes_group(a, mesh), dim)
        return t
    return tree_map(one, local, have, want)


def reshard(local: Any, have: Any, want: Any, mesh) -> Any:
    """Slice the dims ``want`` splits and ``have`` replicates (the inverse
    of ``regather``, no communication).  A sliced leaf is a copy, so the
    whole one is released with its tree."""
    def one(t, h, w):
        whole = t
        for dim, (a, b) in enumerate(zip(h, w)):
            if a == b:
                continue
            if a is not None:
                raise ValueError(f"dim {dim}: {h} -> {w}")
            k = meshctx.axis_size(b, mesh)
            t = t.chunk(k, dim=dim)[meshctx.axis_rank(b, mesh)]
        return t.contiguous() if t is whole else t.clone(
            memory_format=torch.contiguous_format)
    return tree_map(one, local, have, want)
