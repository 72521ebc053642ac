"""Process-global mesh context and the collectives the model code calls —
torch port of ``repro.launch.meshctx``.

The model code is mesh-agnostic: it asks this module for the active mesh
and its (dp_axes, tp_axis) names.  With no mesh (or a mesh whose axes are
all of size 1) every helper below is the identity and the model runs the
meshless math unchanged.

Under a mesh each process holds its local shards and the model calls the
collectives here explicitly, over the mesh's sub-groups:

* ``copy_to_tp`` / ``reduce_from_tp``: the two conjugate operators of
  Megatron-style tensor parallelism.  A column-parallel matmul takes its
  replicated input through ``copy_to_tp`` (identity forward, all-reduce of
  the input's gradient over ``model`` backward); a row-parallel one sums its
  partial products with ``reduce_from_tp`` (all-reduce forward, identity
  backward).  Every leaf replicated over ``model`` then gets its whole
  gradient on every rank.
* ``gather_from_tp``: all-gather along a dim (the vocab-sharded logits).
* ``tp_max``: an all-reduce MAX over ``model`` (no gradient): the TD-VMM
  scales and windows that are maxima over a sharded dim.
* ``dp_*``: the same over the data axes (``("data",)``, or
  ``("pod", "data")`` on a pipeline mesh).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

_MESH = None
_DP_AXES: tuple[str, ...] = ()
_TP_AXIS: Optional[str] = None
_GROUPS: dict = {}


def set_mesh(mesh, dp_axes: tuple[str, ...] = (),
             tp_axis: Optional[str] = None) -> None:
    """Install ``mesh`` (a ``DeviceMesh`` or None).  Collective the first
    time a mesh with two data axes is installed: the flattened data group
    is created on every rank."""
    global _MESH, _DP_AXES, _TP_AXIS
    _MESH = mesh
    _DP_AXES = tuple(dp_axes)
    _TP_AXIS = tp_axis
    if mesh is not None and len(_DP_AXES) > 1:
        axes_group(_DP_AXES)


def get_mesh():
    return _MESH


def dp_axes() -> tuple[str, ...]:
    return _DP_AXES


def tp_axis() -> Optional[str]:
    return _TP_AXIS


class use_mesh:
    """Context manager: install a mesh for the block, restore the old one."""

    def __init__(self, mesh, dp_axes=(), tp_axis=None):
        self.new = (mesh, dp_axes, tp_axis)

    def __enter__(self):
        self.old = (_MESH, _DP_AXES, _TP_AXIS)
        set_mesh(*self.new)
        return self

    def __exit__(self, *a):
        set_mesh(*self.old)


def use_mesh_of(mesh):
    """``use_mesh`` with the axis names ``launch.mesh.axis_info`` gives."""
    from repro_torch.launch.mesh import axis_info
    if mesh is None:
        return use_mesh(None)
    info = axis_info(mesh)
    return use_mesh(mesh, info["dp_axes"], info["tp_axis"])


# --------------------------------------------------------------------------
# Axis sizes, ranks and groups
# --------------------------------------------------------------------------
def axis_size(axes, mesh=None) -> int:
    """Product of the sizes of ``axes`` (a name or a tuple of names)."""
    mesh = _MESH if mesh is None else mesh
    if mesh is None or not axes:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def axis_rank(axes, mesh=None) -> int:
    """This rank's row-major index along ``axes`` (a name or a tuple)."""
    mesh = _MESH if mesh is None else mesh
    if mesh is None or not axes:
        return 0
    if isinstance(axes, str):
        axes = (axes,)
    r = 0
    for a in axes:
        r = r * axis_size(a, mesh) + mesh.get_local_rank(a)
    return r


def axes_group(axes, mesh=None):
    """The process group over ``axes`` (a name or a tuple of names): the
    mesh's own group for one axis, a flattened group (ranks in row-major
    order) for several, made once per rank layout on every rank."""
    mesh = _MESH if mesh is None else mesh
    if isinstance(axes, str):
        axes = (axes,)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    # keyed by the rank layout, not the mesh object: every rank must hit
    # or miss the cache alike, as a miss creates groups collectively.  The
    # layout is read outside any tensor mode (the dry run's fake tensors)
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        key = (tuple(mesh.mesh.flatten().tolist()), tuple(mesh.mesh.shape),
               tuple(mesh.mesh_dim_names), tuple(axes))
        names = list(mesh.mesh_dim_names)
        dims = [names.index(a) for a in axes]
        rest = [d for d in range(len(names)) if d not in dims]
        rows = mesh.mesh.permute(*(rest + dims)).reshape(
            -1, axis_size(axes, mesh)).tolist()
    if key not in _GROUPS:
        _GROUPS[key] = _new_groups(rows)
    return _GROUPS[key]


def _new_groups(rows) -> Optional[object]:
    """A process group of each row of ranks, made on every rank (as
    ``dist.new_group`` requires); this rank's."""
    mine = None
    for row in rows:
        g = dist.new_group(row)
        if dist.get_rank() in row:
            mine = g
    return mine


def tp_size() -> int:
    return axis_size(_TP_AXIS)


def tp_rank() -> int:
    return axis_rank(_TP_AXIS)


def tp_group():
    return axes_group(_TP_AXIS)


def dp_size() -> int:
    return axis_size(_DP_AXES)


def dp_rank() -> int:
    return axis_rank(_DP_AXES)


def dp_group():
    return axes_group(_DP_AXES)


class _Rows:
    split = False


def rows_split() -> bool:
    """This step's rows are one data shard's of a batch split over the data
    axes (``split_rows``): a max over the batch (a data-calibrated TD-VMM
    window, a calibration capture) then spans every data rank."""
    return _Rows.split and dp_active()


class split_rows:
    """Context manager: mark the rows of the block as split (or, with
    ``on=False``, as complete: e.g. an expert-parallel expert's buffer,
    which holds every data rank's rows routed to it)."""

    def __init__(self, on: bool = True):
        self.on = on

    def __enter__(self):
        self.old = _Rows.split
        _Rows.split = self.on
        return self

    def __exit__(self, *a):
        _Rows.split = self.old


def dp_max(x: torch.Tensor) -> torch.Tensor:
    """Elementwise max over the data axes (no gradient)."""
    if not dp_active():
        return x
    return _all_reduce(x.detach(), dp_group(), dist.ReduceOp.MAX)


def dp_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the data axes (no gradient): tallies, and the partial
    softmax sums of a sequence-split cache."""
    if not dp_active():
        return x
    return _all_reduce(x.detach(), dp_group())


def tp_active() -> bool:
    """A mesh with a ``model`` axis of size > 1 is installed."""
    return tp_size() > 1


def dp_active() -> bool:
    return dp_size() > 1


def attn_split(cfg, n: int) -> str:
    """How attention splits over a ``model`` axis of ``n``, in this order:
    "heads" when the heads and KV heads divide; "lanes" (the head-dim
    fallback: every head kept, ``head_dim / n`` lanes of each, which needs
    ``head_dim % 2n == 0`` so that each rank holds whole rotary pairs);
    "groups" when the heads divide and the ranks divide into the KV heads'
    groups (rank r holds query heads ``[r H / n, (r + 1) H / n)`` and the
    one KV head they read, ``r n_kv / n``, replicated on the ``n / n_kv``
    ranks of its group: kimi-k2's 64 heads and 8 KV heads of 112 lanes at
    a model axis of 16, which the JAX package splits by lanes, 7 a rank);
    else "whole": attention kept on every model rank, as the JAX
    package's placements replicate it where head_dim does not divide."""
    if n == 1 or (cfg.n_heads % n == 0 and cfg.n_kv_heads % n == 0):
        return "heads"
    if cfg.resolved_head_dim % (2 * n) == 0:
        return "lanes"
    if cfg.n_heads % n == 0 and n % cfg.n_kv_heads == 0:
        return "groups"
    return "whole"


def local_config(cfg):
    """The model config of one ``model`` shard (``tp_shards`` set): heads
    and KV heads divided over ``model`` (the head dim pinned), or under the
    head-dim fallback every head with its share of lanes, or under the KV
    groups split the rank's heads and its one KV head (``attn_split``;
    ``tp_kv_heads`` keeps the whole model's KV heads); the SSM layers'
    heads, x / z channels and B / C columns divided (``models.ssm``).  The
    identity without tensor parallelism, and on a config that is already a
    shard's.  Apply it once, at a model entry point."""
    n = tp_size()
    if n == 1 or cfg.tp_shards == n:
        return cfg
    if cfg.tp_shards != 1:
        raise ValueError(f"a config of one of {cfg.tp_shards} shards under "
                         f"a model axis of {n}")
    if cfg.ssm is not None:
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        if (d_inner // s.head_dim) % n or (s.n_groups * s.d_state) % n:
            raise ValueError(
                f"{cfg.name}: {d_inner // s.head_dim} SSM heads and "
                f"{s.n_groups * s.d_state} B/C columns over a model axis "
                f"of {n}")
    out = cfg.replace(tp_shards=n)
    if cfg.family == "ssm":
        return out
    mode = attn_split(cfg, n)
    hd = cfg.resolved_head_dim
    if mode == "heads":
        return out.replace(n_heads=cfg.n_heads // n,
                           n_kv_heads=cfg.n_kv_heads // n, head_dim=hd)
    if mode == "lanes":
        return out.replace(attn_split=mode, head_dim=hd // n)
    if mode == "groups":
        return out.replace(attn_split=mode, n_heads=cfg.n_heads // n,
                           n_kv_heads=1, tp_kv_heads=cfg.n_kv_heads,
                           head_dim=hd)
    return out.replace(attn_split=mode, head_dim=hd)


def kv_head(n: int, n_kv: int, r: int) -> int:
    """The KV head ``model`` rank ``r`` of ``n`` holds under the KV groups
    split of ``n_kv`` KV heads."""
    return r * n_kv // n


def kv_group(size: int, mesh=None):
    """The process group of this rank's KV group: the ``size`` consecutive
    ``model`` ranks that hold its KV head, made once per rank layout on
    every rank (``axes_group``'s rule)."""
    mesh = _MESH if mesh is None else mesh
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        names = list(mesh.mesh_dim_names)
        tp = names.index(_TP_AXIS)
        rest = [d for d in range(len(names)) if d != tp]
        rows = mesh.mesh.permute(*(rest + [tp])).reshape(-1, size).tolist()
        key = (tuple(mesh.mesh.flatten().tolist()), tuple(mesh.mesh.shape),
               tuple(names), "kv", size)
    if key not in _GROUPS:
        _GROUPS[key] = _new_groups(rows)
    return _GROUPS[key]


def kv_group_sum(g: torch.Tensor, size: int) -> torch.Tensor:
    """Sum a replicated KV head's gradient over the ``size`` ranks of its
    KV group (each holds only its own query heads' part): all-gathered and
    added in rank order, so every copy of the head gets the same bits."""
    if size == 1:
        return g
    parts = [torch.empty_like(g) for _ in range(size)]
    dist.all_gather(parts, g.contiguous(), group=kv_group(size))
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def lane_index(head_dim: int, n: int, r: int) -> torch.Tensor:
    """Rank ``r``'s lanes of one head of ``head_dim`` under the head-dim
    fallback over ``n`` ranks: a slice of each rotary half (lane i pairs
    with i + head_dim / 2), so the rotation stays within the rank."""
    half, q = head_dim // 2, head_dim // (2 * n)
    lo = torch.arange(r * q, (r + 1) * q)
    return torch.cat([lo, lo + half])


def segment_index(sizes, n: int, r: int) -> torch.Tensor:
    """Rank ``r``'s indices of a dim that concatenates segments of
    ``sizes``, each split contiguously over ``n`` ranks (the SSM's conv
    channels: x, B and C)."""
    out, off = [], 0
    for s in sizes:
        q = s // n
        out.append(torch.arange(off + r * q, off + (r + 1) * q))
        off += s
    return torch.cat(out)


class _Seq:
    split = False


def seq_split() -> bool:
    """The dense KV caches made and read in this block hold one data
    rank's segment of the sequence (a batch the data axes do not divide,
    e.g. ``long_500k``'s batch of 1): each rank keeps a contiguous slice
    of the cache, and a decode step's attention combines the ranks'
    parts (``models.attention._attend_split``)."""
    return _Seq.split and dp_active()


class split_seq:
    """Context manager: mark the block's dense caches as sequence-split."""

    def __init__(self, on: bool = True):
        self.on = on

    def __enter__(self):
        self.old = _Seq.split
        _Seq.split = self.on
        return self

    def __exit__(self, *a):
        _Seq.split = self.old


# --------------------------------------------------------------------------
# Collectives (autograd-aware where the training step needs them)
# --------------------------------------------------------------------------
def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in group-rank order."""
    n = dist.get_world_size(group)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, tp_group())


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x, tp_group())

    @staticmethod
    def backward(ctx, g):
        return g


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, partial):
        ctx.dim, ctx.partial = dim, partial
        return all_gather(x, tp_group(), dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = _all_reduce(g, tp_group())
        return (g.chunk(tp_size(), dim=ctx.dim)[tp_rank()].contiguous(),
                None, None)


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel region: identity forward, the
    gradient all-reduced over ``model`` backward."""
    return _CopyToTP.apply(x) if tp_active() else x


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    """Sum the partial products of a row-parallel region over ``model``."""
    return _ReduceFromTP.apply(x) if tp_active() else x


def gather_from_tp(x: torch.Tensor, dim: int = -1,
                   partial: bool = False) -> torch.Tensor:
    """All-gather a ``model``-sharded dim.  Its gradient is this rank's
    slice of the output's, which every rank holds whole when what follows
    is replicated (the logits); ``partial``: each rank holds only its own
    consumers' share (B and C feed each rank's SSM heads), so the
    gradient is summed over ``model`` first (a reduce-scatter)."""
    if not tp_active():
        return x
    return _GatherFromTP.apply(x, dim % x.dim(), partial)


def tp_max(x: torch.Tensor) -> torch.Tensor:
    """Elementwise max over ``model`` (no gradient: scales and windows)."""
    if not tp_active():
        return x
    return _all_reduce(x.detach(), tp_group(), dist.ReduceOp.MAX)


def tp_sum_exact(x: torch.Tensor) -> torch.Tensor:
    """Sum over ``model`` of integer accumulators (int32, or float32 codes
    whose sums stay integers): exact in any order.  No gradient."""
    if not tp_active():
        return x
    return _all_reduce(x.detach(), tp_group())


def dp_shard(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch (rows split evenly over the data
    axes, rank-major); a batch the data axes do not divide stays whole
    (replicated), as ``sharding.batch_specs`` places it."""
    n = dp_size()
    if n == 1 or x.shape[0] % n:
        return x
    return x.chunk(n, dim=0)[dp_rank()]


def dp_gather(x: torch.Tensor, global_rows: int) -> torch.Tensor:
    """Inverse of ``dp_shard``: the global batch from every rank's rows."""
    n = dp_size()
    if n == 1 or global_rows % n:
        return x
    return all_gather(x, dp_group(), 0)


def dp_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the data axes (no gradient)."""
    if not dp_active():
        return x
    return _all_reduce(x.detach(), dp_group()) / float(dp_size())
