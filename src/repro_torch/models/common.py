"""Shared model components: device resolution, norms, rotary embeddings,
initialized dense layers (torch port of ``repro.models.common``).

Parameters are plain dictionaries of tensors.  Every dense matmul goes
through ``core.layers.td_matmul`` so any linear can execute in TD-VMM mode.
The port runs on one device: there is no mesh, so ``constrain_batch`` is the
identity and ``dense_tp_reduce`` is ``dense``.
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
    """Identity: the port has no device mesh."""
    return x


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
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                       # (D/2,)
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


def dense(params, x: torch.Tensor, td: TDVMMLayerConfig,
          key=None) -> torch.Tensor:
    y = td_matmul(x, params["w"], td, key)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def dense_group(param_group, x: torch.Tensor, td: TDVMMLayerConfig,
                key=None) -> tuple[torch.Tensor, ...]:
    """G same-input dense projections (``attn.qkv``); biases stay
    per-member digital adds."""
    ys = td_grouped_matmul(x, tuple(p["w"] for p in param_group), td, key)
    return tuple(
        y + p["b"].to(y.dtype) if "b" in p else y
        for p, y in zip(param_group, ys))


def dense_tp_reduce(params, x: torch.Tensor, td: TDVMMLayerConfig,
                    key=None) -> torch.Tensor:
    """``dense``: explicit tensor parallelism belongs to the mesh slice."""
    return dense(params, x, td, key)


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "sq_relu":
        r = F.relu(x)
        return r * r
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x, approximate="tanh")
    return F.silu(x)
