"""Gradient compression for the data-parallel all-reduce (int8 + error
feedback) — torch port of ``repro.optim.compression``.

    compressed_all_reduce(x, group, residual)  — quantize (per-block scale)
        -> exchange codes and scales -> dequantize and average; returns the
        residual (this rank's quantization error) for error feedback.

The exchange is a reduce-scatter of the int8 codes and their float32
per-block scales (``all_to_all_single``: rank r receives every rank's
codes of the r-th run of blocks, dequantizes them and sums them in rank
order) and an all-gather of the float32 means, so all ranks hold the same
mean, bit for bit the one every rank would get by summing every rank's
dequantized blocks.  Per element each rank receives (n-1)/n codes and
(n-1)/n float32 means: ~5 (n-1)/n bytes against a float32 ring
all-reduce's 8 (n-1)/n, ~1.6x fewer at any rank count n.
``wire_bytes_saved`` is the JAX package's diagnostic: the payload (float32
gradient against int8 codes + scales), not what a reduction moves.
``launch.steps`` runs it as the data-parallel gradient reduction under
``OptimizerConfig.grad_compression == "int8"``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import leaves, unflatten

BLOCK = 2048


def _quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8: returns (codes int8 (n, BLOCK), scales
    float32 (n, 1))."""
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.shape[0]) % BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    codes = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return codes, scale


def _dequantize_int8(codes: torch.Tensor, scale: torch.Tensor, shape,
                     size: int) -> torch.Tensor:
    flat = (codes.to(torch.float32) * scale).reshape(-1)[:size]
    return flat.reshape(shape)


def compressed_all_reduce(x: torch.Tensor, group=None,
                          residual: torch.Tensor | None = None):
    """int8 mean over ``group`` with error feedback.  Returns (mean-reduced
    x, new_residual); the residual (this rank's quantization error) is
    added back into the next step's x before quantization, the standard
    convergence-preserving trick.  Collective."""
    if residual is not None:
        x = x + residual
    codes, scale = _quantize_int8(x)
    new_residual = x - _dequantize_int8(codes, scale, x.shape, x.numel())
    n = dist.get_world_size(group)
    per = -(-codes.shape[0] // n)                 # blocks a rank reduces
    pad = per * n - codes.shape[0]
    codes = torch.nn.functional.pad(codes, (0, 0, 0, pad))
    scale = torch.nn.functional.pad(scale, (0, 0, 0, pad))
    got_codes, got_scales = torch.empty_like(codes), torch.empty_like(scale)
    dist.all_to_all_single(got_codes, codes, group=group)
    dist.all_to_all_single(got_scales, scale, group=group)
    got_codes = got_codes.reshape(n, per, BLOCK)
    got_scales = got_scales.reshape(n, per, 1)
    summed = got_codes[0].to(torch.float32) * got_scales[0]
    for r in range(1, n):
        summed = summed + got_codes[r].to(torch.float32) * got_scales[r]
    means = [torch.empty_like(summed) for _ in range(n)]
    dist.all_gather(means, summed / float(n), group=group)
    return (torch.cat(means).reshape(-1)[:x.numel()].reshape(x.shape),
            new_residual)


def compressed_tree_all_reduce(grads, group=None, residuals=None):
    """``compressed_all_reduce`` leaf by leaf over a gradient tree; returns
    (reduced tree, residual tree)."""
    gs = leaves(grads)
    rs = leaves(residuals) if residuals is not None else [None] * len(gs)
    out, new_res = [], []
    for g, r in zip(gs, rs):
        y, nr = compressed_all_reduce(g, group, r)
        out.append(y)
        new_res.append(nr)
    return unflatten(grads, out), unflatten(grads, new_res)


def wire_bytes_saved(grads) -> float:
    """Float32 bytes minus int8 + scale bytes for one DP reduce."""
    total = sum(g.numel() for g in leaves(grads))
    f32 = 4.0 * total
    int8 = 1.0 * total + 4.0 * (total / BLOCK)
    return f32 - int8
