"""Mamba-2 blocks (state-space duality, arXiv:2405.21060) — torch port of
``repro.models.ssm``: training (``apply_train``), prefill and decode.

Recurrence (per head h, head channels P, state channels S):

    H_t = exp(A * dt_t) * H_{t-1} + dt_t * B_t (x) x_t          H: (P, S)
    y_t = C_t . H_t + D * x_t

Prefill runs the chunked scan through ``kernels.ssd.ssd.ssd_scan``: kernel B3 for
a tensor on the card, its plain version (the JAX package's ``ssd_chunked``)
for a CPU tensor.  Training runs that plain version under autograd on
either device, as the JAX package trains through ``ssd_chunked``.  Decode
is the single-token recurrence in plain torch, as it is plain ``jnp`` in
the JAX package.  The z/x/B/C/dt input projections
run as ONE grouped TD-VMM launch (site ``ssm.in_proj``); the output
projection is site ``ssm.out``.

Under a mesh's ``model`` axis (a config of ``meshctx.local_config``, with
``tp_shards`` > 1) a block runs on its shard, following the JAX package's
placements (``launch.sharding``): the heads, their x and z channels and
``dt`` are column shards of the grouped launch; so are B and C, whose
``d_state`` columns the placement splits (both archs have one group), so
each rank all-gathers them after the conv (``meshctx.gather_from_tp``,
exact) to scan its heads against the whole B and C; the conv's channels
are the rank's x, B and C segments (``meshctx.segment_index``).  The
member windows of ``ssm.in_proj`` are then maxima over every rank's
columns, the meshless windows.  The gated RMSNorm's sum of squares over
``d_inner`` is summed over ``model`` (a float sum in another order:
``norm_var``), and ``wo`` (site ``ssm.out``) is row-parallel: B1 raw, its
int32 sums over ``model``, one epilogue.  Replicating B and C instead
would keep the gather out but hold the d_state-wide projection whole on
every rank and need its gradient summed; the placement keeps the weights
split and costs one small all-gather per block.

Caches are updated **in place**: ``apply_prefill``/``apply_decode`` write
the new conv context and state into the cache tensors they are given (views
into the model's stacked per-layer caches) and return them with the
advanced positions.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd import ssd as ssd_b3
from repro_torch.launch import meshctx
from repro_torch.models import common


class SSMCache(NamedTuple):
    conv: torch.Tensor       # (B, d_conv-1, conv_channels) — last conv inputs
    state: torch.Tensor      # (B, H, P, S) float32 — SSD recurrent state
    pos: torch.Tensor        # (B,) int32


def _dims(cfg: ModelConfig):
    """(d_inner, heads, conv channels) of one ``model`` shard."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model // cfg.tp_shards
    n_heads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * _bc(cfg)
    return d_inner, n_heads, conv_ch


def _bc(cfg: ModelConfig) -> int:
    """B (and C) columns of one ``model`` shard."""
    return cfg.ssm.n_groups * cfg.ssm.d_state // cfg.tp_shards


def _gather_bc(bc: torch.Tensor, cc: torch.Tensor, cfg: ModelConfig):
    """The whole B and C from every rank's columns (each rank's heads then
    read all of them, so the gradient is summed over ``model``)."""
    if cfg.tp_shards == 1:
        return bc, cc
    return (meshctx.gather_from_tp(bc, -1, partial=True),
            meshctx.gather_from_tp(cc, -1, partial=True))


def init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_inner, n_heads, conv_ch = _dims(cfg)
    f32 = torch.float32
    u = torch.rand((n_heads,), generator=gen, dtype=f32, device=device)
    dt = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                   + math.log(s.dt_min))
    dt_bias = dt + torch.log(-torch.expm1(-dt))          # inverse softplus
    conv_w = torch.randn((s.d_conv, 1, conv_ch), generator=gen, dtype=f32,
                         device=device) * 0.1
    return {
        "wz": common.dense_init(gen, d, d_inner, dtype, device),
        "wx": common.dense_init(gen, d, d_inner, dtype, device),
        "wB": common.dense_init(gen, d, s.n_groups * s.d_state, dtype, device),
        "wC": common.dense_init(gen, d, s.n_groups * s.d_state, dtype, device),
        "wdt": common.dense_init(gen, d, n_heads, dtype, device),
        "dt_bias": dt_bias,
        "A_log": torch.log(torch.arange(1, n_heads + 1, dtype=f32,
                                        device=device)),
        "D": torch.ones((n_heads,), dtype=f32, device=device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "norm": common.rmsnorm_init(d_inner, dtype, device),
        "wo": common.dense_init(gen, d_inner, d, dtype, device),
    }


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            left_ctx: Optional[torch.Tensor] = None):
    """Causal depthwise conv.  x: (B, L, C); w: (width, 1, C).

    left_ctx: (B, width-1, C) previous inputs (decode), else zeros.  The
    taps are shifted multiply-adds summed in float32 and rounded once to
    x's dtype, then the bias is added (no cuDNN, so no TF32).
    Returns (y, new_left_ctx)."""
    width = w.shape[0]
    bsz, L, ch = x.shape
    if left_ctx is None:
        left_ctx = torch.zeros((bsz, width - 1, ch), dtype=x.dtype,
                               device=x.device)
    xp = torch.cat([left_ctx.to(x.dtype), x], dim=1)
    wf = w.to(x.dtype).to(torch.float32)[:, 0, :]          # (width, C)
    acc = xp[:, 0:L].to(torch.float32) * wf[0]
    for k in range(1, width):
        acc = acc + xp[:, k:k + L].to(torch.float32) * wf[k]
    y = acc.to(x.dtype) + b.to(x.dtype)
    new_ctx = xp[:, L:] if width > 1 else left_ctx
    return y, new_ctx


class _Softplus(torch.autograd.Function):
    """log(1 + exp(x)) as ``jnp.logaddexp(x, 0)`` evaluates it, with the
    gradient of its custom JVP, ``exp(x - softplus(x))`` (autograd of the
    forward's terms rounds differently: training's dt gradients)."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(x - out)


_softplus = _Softplus.apply


def ssd_decode_step(state, x, dt, a_log, b, c):
    """Single-token recurrence.  x: (B, H, P); dt: (B, H); b, c: (B, G, S);
    state: (B, H, P, S).  Returns (y (B, H, P), new_state)."""
    H = x.shape[1]
    G = b.shape[1]
    rep = H // G
    f32 = torch.float32
    bh = b.repeat_interleave(rep, dim=1).to(f32)          # (B, H, S)
    ch = c.repeat_interleave(rep, dim=1).to(f32)
    a = -torch.exp(a_log.to(f32))
    dta = dt.to(f32) * a                                  # (B, H)
    decay = torch.exp(dta)[:, :, None, None]
    upd = torch.einsum("bhs,bh,bhp->bhps", bh, dt.to(f32), x.to(f32))
    new_state = state * decay + upd
    y = torch.einsum("bhs,bhps->bhp", ch, new_state)
    return y.to(x.dtype), new_state


def _project(params, u: torch.Tensor, cfg: ModelConfig, key=None):
    """z/x/B/C/dt input projections as ONE grouped TD-VMM launch (site
    ``ssm.in_proj``): u is encoded once for the five weight matrices."""
    td = cfg.site_tdvmm("ssm.in_proj")
    return common.dense_group(
        (params["wz"], params["wx"], params["wB"], params["wC"],
         params["wdt"]), u, td, key)


def init_cache(cfg: ModelConfig, batch: int, dtype, device) -> SSMCache:
    s = cfg.ssm
    d_inner, n_heads, conv_ch = _dims(cfg)
    return SSMCache(
        conv=torch.zeros((batch, s.d_conv - 1, conv_ch), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, n_heads, s.head_dim, s.d_state),
                          dtype=torch.float32, device=device),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device))


TP_ORDER = 1   # > 1: the meshless norm_var sums in a TP shard's order


def norm_var(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The gated RMSNorm's mean of squares over ``d_inner`` (float32 x,
    keepdim).  On a ``model`` shard each rank's sum of squares, summed over
    ``model`` (the sum entering this rank's lanes as a column-parallel
    input: its gradient is summed back).  Meshless with ``TP_ORDER`` n > 1
    (``chip_smoke.tp_order``): the same n partial sums added in rank
    order, which a 1 x n run reproduces bit for bit."""
    if cfg.tp_shards > 1:
        ss = torch.sum(torch.square(x), dim=-1, keepdim=True)
        ss = meshctx.copy_to_tp(meshctx.reduce_from_tp(ss))
        return ss / float(x.shape[-1] * cfg.tp_shards)
    if TP_ORDER > 1:
        ss = None
        for part in torch.chunk(x, TP_ORDER, dim=-1):
            p = torch.sum(torch.square(part.contiguous()), dim=-1,
                          keepdim=True)
            ss = p if ss is None else ss + p
        return ss / float(x.shape[-1])
    return torch.mean(torch.square(x), dim=-1, keepdim=True)


def _gate_out(params, y, z, cfg: ModelConfig, key):
    h = y * F.silu(z)
    if cfg.tp_shards == 1 and TP_ORDER == 1:
        h = common.rmsnorm(params["norm"], h, cfg.norm_eps)
    else:
        # common.rmsnorm's arithmetic around a sharded mean of squares
        x = h.to(torch.float32)
        x = x * torch.rsqrt(norm_var(x, cfg) + cfg.norm_eps)
        h = (x * params["norm"]["scale"].to(torch.float32)).to(h.dtype)
    return common.dense(params["wo"], h, cfg.site_tdvmm("ssm.out"), key,
                        tp="row")


def _sequence(params, u: torch.Tensor, cfg: ModelConfig, key, left_ctx,
              scan) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A whole sequence through the block: projections, causal conv (after
    ``left_ctx``, None for zeros), gates, the chunked scan ``scan``, the
    output projection.  u: (B, L, d).  Returns (out, conv context, final
    state)."""
    s = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    bsz, L, _ = u.shape
    z, xc, bc, cc, dt = _project(params, u, cfg, key)
    xbc = torch.cat([xc, bc, cc], dim=-1)
    xbc, conv_ctx = _conv1d(xbc, params["conv_w"], params["conv_b"],
                            left_ctx)
    xbc = F.silu(xbc)
    gs = _bc(cfg)
    xc, bc, cc = torch.split(xbc, [d_inner, gs, gs], dim=-1)
    bc, cc = _gather_bc(bc, cc, cfg)
    dt = _softplus(dt.to(torch.float32) + params["dt_bias"])
    xh = xc.reshape(bsz, L, n_heads, s.head_dim)
    bg = bc.reshape(bsz, L, s.n_groups, s.d_state)
    cg = cc.reshape(bsz, L, s.n_groups, s.d_state)
    y, state = scan(xh, dt, params["A_log"], bg, cg, s.chunk)
    y = y + params["D"].to(y.dtype)[None, None, :, None] * xh
    out = _gate_out(params, y.reshape(bsz, L, d_inner), z, cfg, key)
    return out, conv_ctx, state


def apply_train(params, u: torch.Tensor, cfg: ModelConfig,
                key=None) -> torch.Tensor:
    """Full-sequence Mamba-2 block for training, from a zero state.
    u: (B, L, d).  The scan is ``ssd.ssd_plain`` under autograd (B3 has no
    backward; the JAX package's training path runs its jnp
    ``ssd_chunked``, not its Pallas kernel)."""
    return _sequence(params, u, cfg, key, None, ssd_b3.ssd_plain)[0]


def apply_prefill(params, u: torch.Tensor, cfg: ModelConfig, cache: SSMCache,
                  key=None) -> tuple[torch.Tensor, SSMCache]:
    """Absorb a prompt.  u: (B, L, d)."""
    bsz, L, _ = u.shape
    out, conv_ctx, state = _sequence(params, u, cfg, key, cache.conv,
                                     ssd_b3.ssd_scan)
    cache.conv.copy_(conv_ctx)
    cache.state.copy_(state)
    return out, SSMCache(cache.conv, cache.state,
                         torch.full((bsz,), L, dtype=torch.int32,
                                    device=u.device))


def apply_decode(params, u: torch.Tensor, cfg: ModelConfig, cache: SSMCache,
                 key=None) -> tuple[torch.Tensor, SSMCache]:
    """One-token step.  u: (B, 1, d)."""
    s = cfg.ssm
    d_inner, n_heads, conv_ch = _dims(cfg)
    bsz = u.shape[0]
    z, xc, bc, cc, dt = _project(params, u, cfg, key)
    xbc = torch.cat([xc, bc, cc], dim=-1)                 # (B, 1, conv_ch)
    xbc, conv_ctx = _conv1d(xbc, params["conv_w"], params["conv_b"],
                            cache.conv)
    xbc = F.silu(xbc)[:, 0]
    gs = _bc(cfg)
    xc1, bc1, cc1 = torch.split(xbc, [d_inner, gs, gs], dim=-1)
    bc1, cc1 = _gather_bc(bc1, cc1, cfg)
    dt1 = _softplus(dt[:, 0].to(torch.float32) + params["dt_bias"])
    xh = xc1.reshape(bsz, n_heads, s.head_dim)
    bg = bc1.reshape(bsz, s.n_groups, s.d_state)
    cg = cc1.reshape(bsz, s.n_groups, s.d_state)
    y, state = ssd_decode_step(cache.state, xh, dt1, params["A_log"], bg, cg)
    y = y + params["D"].to(y.dtype)[None, :, None] * xh
    out = _gate_out(params, y.reshape(bsz, 1, d_inner), z, cfg, key)
    cache.conv.copy_(conv_ctx)
    cache.state.copy_(state)
    return out, SSMCache(cache.conv, cache.state, cache.pos + 1)
