"""Shared model components: device resolution, norms, rotary embeddings,
initialized dense layers (torch port of ``repro.models.common``).

Parameters are plain dictionaries of tensors.  Every dense matmul goes
through ``core.layers.td_matmul`` so any linear can execute in TD-VMM mode.

Under a mesh (``launch.meshctx``) each process holds its shards: a dense
layer is column-parallel (its weight's columns over ``model``: the input
enters through ``meshctx.copy_to_tp``, the output stays split) or
row-parallel (its rows over ``model``: partial products summed over
``model``), as ``launch.sharding`` places it.  With no mesh, or a ``model``
axis of 1, both are the meshless layer.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.layers import TDVMMLayerConfig, td_grouped_matmul, td_matmul


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    card.  With no card and no explicit device this raises — an entry point
    never drops to the CPU unless the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain torch path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch: the batch dim split over the DP
    axes (``meshctx.dp_shard``; a batch they do not divide, e.g. batch 1,
    stays replicated).  The identity without a mesh."""
    from repro_torch.launch import meshctx
    return meshctx.dp_shard(x)


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------
def rmsnorm_init(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].to(torch.float32)).to(dtype)


# --------------------------------------------------------------------------
# Rotary position embeddings (rotate-half convention)
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float, freqs: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int32.  ``freqs`` (D/2,) gives
    the lanes' own frequencies (a head-dim shard's slice of the whole
    head's), else those of a D-lane head."""
    d = x.shape[-1]
    if freqs is None:
        freqs = rope_freqs(d, theta, x.device)                   # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs      # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Dense (TD-VMM-aware)
# --------------------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               bias: bool = False, scale: Optional[float] = None) -> dict:
    scale = (d_in ** -0.5) if scale is None else scale
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device) * scale
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def _tp() -> bool:
    from repro_torch.launch import meshctx
    return meshctx.tp_active()


def dense(params, x: torch.Tensor, td: TDVMMLayerConfig,
          key=None, tp: Optional[str] = "col", shard=None) -> torch.Tensor:
    """``tp``: "col" (columns split over ``model``; the default, as every
    sharded dense weight of the dense and MoE families but the reductions
    is), "row" (rows split; the output summed over ``model``) or None
    (replicated).  ``shard``: the shard's columns (rows) within the whole
    weight when they are not this rank's contiguous chunk (programming
    noise is drawn for the whole weight)."""
    if not _tp() or tp is None:
        y = td_matmul(x, params["w"], td, key)
    elif tp == "col":
        from repro_torch.launch import meshctx
        y = td_matmul(meshctx.copy_to_tp(x), params["w"], td, key, tp="col",
                      shard=shard)
    else:
        y = _row(params, x, td, key, explicit=False, shard=shard)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def _row(params, x, td: TDVMMLayerConfig, key, explicit: bool,
         shard=None):
    from repro_torch.launch import meshctx
    if td.enabled:
        # the TD-VMM row site sums its raw accumulators over ``model``
        return td_matmul(x, params["w"], td, key, tp="row", shard=shard)
    if explicit:
        return meshctx.reduce_from_tp((x @ params["w"]).to(torch.bfloat16))
    return row_sum(x, params["w"])


def row_sum(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A row-parallel product ``x @ w`` over ``model`` (``w`` (K, N), or
    (E, K, N) batched over experts): each rank's float32 partial product
    (``partial_f32``), summed over ``model`` in float32 and rounded to the
    model's dtype once, as the meshless matmul's float32 accumulator is."""
    from repro_torch.launch import meshctx
    return meshctx.reduce_from_tp(partial_f32(x, w)).to(x.dtype)


def partial_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with a float32 result.  On the card, operands of a 16-bit
    dtype go through the tensor cores with float32 output (``torch.mm`` /
    ``torch.bmm`` with ``out_dtype``), no float32 copy of either; torch has
    no CPU kernel for that, and the CPU forms the same exact products from
    float32 copies.  Gradients come back in the operands' dtype, as the
    meshless matmul's do."""
    return _PartialF32.apply(x, w)


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels import hooks
    if x.dtype == torch.float32 or not hooks.card_route(x):
        return x.to(torch.float32) @ w.to(torch.float32)
    if w.dim() == 3:
        return torch.bmm(x, w, out_dtype=torch.float32)
    y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
    return y.reshape(*x.shape[:-1], w.shape[-1])


class _PartialF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = g @ w.transpose(-1, -2)
        if w.dim() == 3:
            gw = x.transpose(-1, -2) @ g
        else:
            gw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return gx, gw.to(w.dtype)


def dense_group(param_group, x: torch.Tensor, td: TDVMMLayerConfig,
                key=None, tp: Optional[str] = "col", shard=None,
                replicas=None) -> tuple[torch.Tensor, ...]:
    """G same-input dense projections (``attn.qkv``); biases stay
    per-member digital adds.  Column-parallel under a mesh (``tp="col"``),
    or replicated (``tp=None``); ``shard`` and ``replicas`` as
    ``td_grouped_matmul``'s."""
    if _tp() and tp is not None:
        from repro_torch.launch import meshctx
        x = meshctx.copy_to_tp(x)
    else:
        tp = None
    ys = td_grouped_matmul(x, tuple(p["w"] for p in param_group), td, key,
                           tp=tp, shard=shard, replicas=replicas)
    return tuple(
        y + p["b"].to(y.dtype) if "b" in p else y
        for p, y in zip(param_group, ys))


# --------------------------------------------------------------------------
# Explicit-TP reduction matmul
# --------------------------------------------------------------------------
# The two reduction matmuls of each training block (attn wo, ffn w_down)
# are row-parallel.  With ``TP_EXPLICIT`` on, the partial products are cast
# to bf16 before the all-reduce over ``model`` (halving its bytes), as the
# JAX package's explicit path does; off, they are summed in their own
# dtype.  A TD-VMM site always sums its exact raw accumulators.
TP_EXPLICIT = False


def set_tp_explicit(on: bool) -> None:
    global TP_EXPLICIT
    TP_EXPLICIT = on


def dense_tp_reduce(params, x: torch.Tensor, td: TDVMMLayerConfig,
                    key=None, shard=None) -> torch.Tensor:
    """x: (..., f) with f split over ``model``; w: (f, d) with its rows
    split (``shard`` as ``dense``'s).  Without a tensor-parallel mesh,
    ``dense``."""
    if not _tp():
        return dense(params, x, td, key)
    y = _row(params, x, td, key, explicit=TP_EXPLICIT, shard=shard)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "sq_relu":
        r = F.relu(x)
        return r * r
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x, approximate="tanh")
    return F.silu(x)
