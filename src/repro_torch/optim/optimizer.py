"""Optimizers over parameter trees: AdamW and Adafactor — torch port of
``repro.optim.optimizer``.

Plain functions over the port's parameter dicts (not ``torch.optim``), so
each update is the JAX package's term for term: the same association, the
same float32 arithmetic and the bf16 or float32 moments of
``OptimizerConfig.moment_dtype``.  Updates are functional: ``update``
returns new parameter and state trees.  Adafactor (factored second moments,
update clipping) exists for the 1T-parameter config, as in the JAX package.

Under a mesh the state holds this rank's shards (``launch.sharding``):
``update(..., specs=)`` takes the gradients' placements, and every
reduction over a split dim — the global norm, Adafactor's row and column
means and its update RMS — is summed over the axes that split it, so the
step is the meshless step on the whole tensors (in float32 sums of another
association).  A KV head that the ranks of its KV group each hold (the KV
groups split) is counted once, on the first of them.  ``grad_compression="int8"`` selects the int8 error-feedback
all-reduce for the data-parallel gradient reduction (``optim.compression``,
run by ``launch.steps``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.tree import leaves, tree_map


class OptState(NamedTuple):
    step: torch.Tensor       # () int32: updates applied so far
    inner: Any


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine decay to 0.1 x lr at
    ``total_steps``; float32."""
    step = step.to(torch.float32)
    warm = torch.clamp_max(step / float(max(cfg.warmup_steps, 1)), 1.0)
    prog = torch.clamp((step - float(cfg.warmup_steps))
                       / float(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(float(torch.pi) * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _split_axes(spec) -> tuple:
    """The mesh axes of size > 1 that split a leaf placed by ``spec``."""
    from repro_torch.launch import meshctx
    out = []
    for ax in (spec or ()):
        if ax is None:
            continue
        for a in ((ax,) if isinstance(ax, str) else ax):
            if meshctx.axis_size(a) > 1:
                out.append(a)
    return tuple(sorted(set(out)))


def _copies(spec) -> int:
    """How many ``model`` ranks hold each of a leaf's columns (the KV
    groups split's ``wk`` / ``wv``: the ranks of a KV group); else 1."""
    from repro_torch.launch import meshctx, sharding
    ax = sharding.groups_entry(spec)
    return 1 if ax is None else ax.copies(meshctx.axis_size(ax))


def _counted(t: torch.Tensor, spec) -> torch.Tensor:
    """``t``, a partial sum over a leaf's shard, as the reduction over
    the ranks counts it: zero on a rank whose copy of a KV head the first
    rank of its KV group counts."""
    c = _copies(spec)
    if c == 1:
        return t
    from repro_torch.launch import meshctx, sharding
    rank = meshctx.axis_rank(sharding.groups_entry(spec))
    return t if rank % c == 0 else torch.zeros_like(t)


def _sum_over(t: torch.Tensor, axes: tuple) -> torch.Tensor:
    if not axes:
        return t
    import torch.distributed as dist
    from repro_torch.launch import meshctx
    out = t.clone()
    dist.all_reduce(out, group=meshctx.axes_group(axes))
    return out


def global_norm(tree, specs=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf; with ``specs`` (the
    leaves' placements under the installed mesh) of the whole leaves."""
    gs = leaves(tree)
    split = [_split_axes(s) for s in leaves(specs)] if specs is not None \
        else [()] * len(gs)
    if not any(split):
        total = 0
        for g in gs:
            total = total + torch.sum(torch.square(g.to(torch.float32)))
        return torch.sqrt(total)
    by_axes: dict = {}
    for g, axes, spec in zip(gs, split, leaves(specs)):
        sq = _counted(torch.sum(torch.square(g.to(torch.float32))), spec)
        by_axes[axes] = by_axes[axes] + sq if axes in by_axes else sq
    total = 0
    for axes in sorted(by_axes):
        total = total + _sum_over(by_axes[axes], axes)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, specs=None):
    """(grads scaled to a global norm of at most ``max_norm``, as float32;
    the norm before clipping)."""
    gnorm = global_norm(grads, specs)
    scale = torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), gnorm


def _moment_dtype(cfg: OptimizerConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------
def _adamw_init(params, cfg: OptimizerConfig):
    mdt = _moment_dtype(cfg)
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)  # noqa: E731
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def _adamw_update(grads, inner, params, cfg: OptimizerConfig, step, lr):
    b1, b2 = cfg.b1, cfg.b2
    t = step.to(torch.float32) + 1.0
    corr = torch.sqrt(1 - torch.pow(_f32(b2, t), t)) \
        / (1 - torch.pow(_f32(b1, t), t))

    def upd(g, m, v, p):
        g = g.to(torch.float32)
        m32, v32 = m.to(torch.float32), v.to(torch.float32)
        m_new = b1 * m32 + (1 - b1) * g
        v_new = b2 * v32 + (1 - b2) * g * g
        u = corr * m_new / (torch.sqrt(v_new) + cfg.eps)
        u = u + cfg.weight_decay * p.to(torch.float32)
        p_new = p.to(torch.float32) - lr * u
        return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

    out = tree_map(upd, grads, inner["m"], inner["v"], params)
    return _pick(out, params, 0), {"m": _pick(out, params, 1),
                                   "v": _pick(out, params, 2)}


def _pick(out, like, i: int):
    """Tree ``i`` of a tree shaped like ``like`` whose leaves are tuples."""
    return tree_map(lambda _, o: o[i], like, out)


# --------------------------------------------------------------------------
# Adafactor (Shazeer & Stern, 2018): factored v for >= 2-D params
# --------------------------------------------------------------------------
def _adafactor_init(params, cfg: OptimizerConfig):
    mdt = _moment_dtype(cfg)

    def per_param(p):
        st = {"m": torch.zeros(p.shape, dtype=mdt, device=p.device)}
        if p.dim() >= 2:
            st["vr"] = torch.zeros(p.shape[:-1], dtype=torch.float32,
                                   device=p.device)
            st["vc"] = torch.zeros(p.shape[:-2] + p.shape[-1:],
                                   dtype=torch.float32, device=p.device)
        else:
            st["v"] = torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
        return st

    return tree_map(per_param, params)


def _mean(x: torch.Tensor, dim, spec, keepdim: bool = False):
    """``torch.mean`` over ``dim`` (an int, or None for every dim) of the
    whole tensor whose shard ``x`` is: a dim split over mesh axes is summed
    over them and divided by its whole size (a KV head held by several
    ranks counted once)."""
    dims = tuple(range(x.dim())) if dim is None else (dim % x.dim(),)
    sub = [spec[d] for d in dims] if spec is not None else None
    axes = _split_axes(sub)
    if not axes:
        return torch.mean(x) if dim is None else \
            torch.mean(x, dim=dim, keepdim=keepdim)
    from repro_torch.launch import meshctx
    n = 1
    for d in dims:
        n *= x.shape[d]
    n *= meshctx.axis_size(axes) // _copies(sub)
    total = _counted(torch.sum(x, dim=dims, keepdim=keepdim), sub)
    return _sum_over(total, axes) / float(n)


def _adafactor_update(grads, inner, params, cfg: OptimizerConfig, step, lr,
                      specs=None):
    t = step.to(torch.float32) + 1.0
    decay = 1.0 - torch.pow(t, -0.8)     # time-dependent decay (the paper's)

    def upd(g, p, st, spec=None):
        g = g.to(torch.float32)
        g2 = g * g + 1e-30
        if p.dim() >= 2:
            vr = decay * st["vr"] + (1 - decay) * _mean(g2, -1, spec)
            vc = decay * st["vc"] + (1 - decay) * _mean(g2, -2, spec)
            vr_spec = None if spec is None else tuple(spec)[:-1]
            denom = torch.clamp_min(_mean(vr, -1, vr_spec, keepdim=True),
                                    1e-30)
            vhat = (vr[..., None] / denom[..., None]) * vc[..., None, :]
            u = g / torch.sqrt(vhat + 1e-30)
            new_v = {"vr": vr, "vc": vc}
        else:
            v = decay * st["v"] + (1 - decay) * g2
            u = g / torch.sqrt(v + 1e-30)
            new_v = {"v": v}
        # update clipping (RMS <= 1)
        rms = torch.sqrt(_mean(u * u, None, spec) + 1e-30)
        u = u / torch.clamp_min(rms, 1.0)
        m = cfg.b1 * st["m"].to(torch.float32) + (1 - cfg.b1) * u
        u = m + cfg.weight_decay * p.to(torch.float32)
        p_new = (p.to(torch.float32) - lr * u).to(p.dtype)
        return p_new, {"m": m.to(st["m"].dtype), **new_v}

    # the state holds one dict per parameter, at the parameter's place
    if specs is None:
        out = tree_map(upd, grads, params, inner)
    else:
        out = tree_map(lambda g, p, st, sp: upd(g, p, st, sp), grads, params,
                       inner, specs)
    return _pick(out, params, 0), _pick(out, params, 1)


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Optimizer:
    cfg: OptimizerConfig

    def init(self, params) -> OptState:
        init = _adafactor_init if self.cfg.name == "adafactor" else _adamw_init
        device = leaves(params)[0].device
        return OptState(step=torch.zeros((), dtype=torch.int32,
                                         device=device),
                        inner=init(params, self.cfg))

    @torch.no_grad()
    def update(self, grads, state: OptState, params, specs=None):
        """Returns (new_params, new_state, metrics {"grad_norm", "lr"}).
        ``specs``: the placements of ``params`` (and ``grads``) under the
        installed mesh, when they are shards."""
        grads, gnorm = clip_by_global_norm(grads, self.cfg.grad_clip, specs)
        lr = lr_schedule(self.cfg, state.step)
        if self.cfg.name == "adafactor":
            new_params, new_inner = _adafactor_update(
                grads, state.inner, params, self.cfg, state.step, lr, specs)
        else:
            new_params, new_inner = _adamw_update(
                grads, state.inner, params, self.cfg, state.step, lr)
        return new_params, OptState(state.step + 1, new_inner), {
            "grad_norm": gnorm, "lr": lr}


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    if cfg.grad_compression not in ("none", "int8"):
        raise ValueError(f"grad_compression={cfg.grad_compression!r}: "
                         "'none' or 'int8'")
    return Optimizer(cfg)
