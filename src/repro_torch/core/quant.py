"""Quantized-code subsystem (serving path): encode -> program -> codes.

The paper's multiplier is an *integer-code* machine: p-bit time codes in,
current codes as weights, charge accumulation, p-bit readout.  This module
holds the two code stages the serving path runs before the TD-VMM kernel:

    encode_input      Eq. 2 / section 4.2 — the shared-counter DAC converts a
                      normalized activation into a p-bit rising-edge time code
                      (sign = differential wire pair), per-row range scale.
    program_weights   sections 2, 4.1 — floating-gate tuning programs each
                      cell's current to one of 2^p_w levels, per-output-column
                      scale.

Codes are **bitwise** those of the JAX package (``repro.core.quant``): the
normalization is the division ``xf / s`` (never a reciprocal multiply), the
scale is ``max(max|x| with initial 0, 1e-6)``, and rounding is half to even.
Every constant enters as an explicit float32 tensor, so no double-precision
scalar arithmetic sneaks in.  ``concat_group`` joins G programmed members
into the ragged bank of a grouped launch.  Only int8 storage (p <= 7) is
ported; there is no straight-through-estimator term because the port serves
only.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import encoding as enc

# Signed-magnitude codes span [-(2^p - 1), 2^p - 1]: int8 holds p <= 7.
INT8_MAX_BITS = 7
# A signed nibble holds [-8, 7] ⊇ [-7, 7]: p <= 3 packs two codes per byte.
INT4_MAX_BITS = 3


def storage_dtype(bits: int) -> torch.dtype:
    """Canonical code storage: int8 when the signed code range fits."""
    return torch.int8 if bits <= INT8_MAX_BITS else torch.float32


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """Integer codes + the scale that maps them back to model units.

    codes:  int8 in [-levels, levels] (p <= 7).
    scale:  f32, per-row ``(..., 1)`` for activations, per-channel ``(1, N)``
            or per-tensor ``(1, 1)`` for weights.
    bits:   code width p.
    """

    codes: torch.Tensor
    scale: torch.Tensor
    bits: int

    @property
    def levels(self) -> int:
        return (1 << self.bits) - 1


def _store(normalized: torch.Tensor, bits: int) -> torch.Tensor:
    """int8 codes for a normalized value in [-1, 1]."""
    if storage_dtype(bits) != torch.int8:
        raise NotImplementedError(
            f"{bits}-bit codes need float32 storage, which the port does not "
            "serve yet (ROADMAP: B1's remaining modes)")
    return enc.quantize_code_signed(normalized, bits).to(torch.int8)


def _floor(t: torch.Tensor, value: float) -> torch.Tensor:
    # a float32 tensor against a Python scalar: the bound is rounded to
    # float32, as jnp.maximum does with a weakly typed constant; NaN stays NaN
    return torch.clamp_min(t, value)


def _absmax(xf: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
    """max|x| over ``dims`` with keepdims and an initial value of 0 (so a
    zero-size reduction gives 0, as ``jnp.max(..., initial=0.0)`` does)."""
    if xf.numel() == 0:
        shape = list(xf.shape)
        for d in dims:
            shape[d] = 1
        return torch.zeros(shape, dtype=torch.float32, device=xf.device)
    return _floor(torch.amax(torch.abs(xf), dim=dims, keepdim=True), 0.0)


def encode_input(x: torch.Tensor, bits: int, axis: int = -1) -> QuantizedTensor:
    """Input stage (Eq. 2): per-row range normalization + p-bit time codes.

    The scale is the per-example input range max|x| along ``axis`` (the
    analog front-end normalizes each sample into the [0, T] window).
    """
    xf = x.to(torch.float32)
    s = _floor(_absmax(xf, (axis,)), 1e-6)
    return QuantizedTensor(codes=_store(xf / s, bits), scale=s, bits=bits)


def program_weights(
    w: torch.Tensor, bits: int, per_channel: bool = True
) -> QuantizedTensor:
    """Weight stage (sections 2, 4.1): FG current codes + column scaling.

    ``per_channel`` scales each output column independently (axis -2 of a
    (N_in, N_out) matrix); otherwise one scale per weight tile.
    """
    wf = w.to(torch.float32)
    dims = (-2,) if per_channel else (-2, -1)
    w_max = _floor(_absmax(wf, dims), 1e-6)
    return QuantizedTensor(codes=_store(wf / w_max, bits), scale=w_max,
                           bits=bits)


def concat_group(qws, widths: tuple[int, ...]) -> QuantizedTensor:
    """Concatenate G programmed (K, N_g) members along N into one ragged bank.

    The ragged grouped launch (``core.layers.td_grouped_matmul``) runs one
    shared input against the column concat of G same-input projections:
    member g owns a ``widths[g]``-wide column span (its width rounded up to
    the 128 lane).  Pad columns carry zero codes, which integrate zero
    charge, and scale 1.0, which only ever multiplies a zero output."""
    qws = tuple(qws)
    if not qws:
        raise ValueError("concat_group needs at least one member")
    if len(widths) != len(qws):
        raise ValueError(f"{len(widths)} widths for {len(qws)} members")
    bits = qws[0].bits
    if any(q.bits != bits for q in qws):
        raise ValueError(f"grouped members must share a code width, got "
                         f"{[q.bits for q in qws]}")
    if any(q.codes.dim() != 2 for q in qws):
        raise ValueError("concat_group concatenates 2-D (K, N) members")
    if any(q.codes.shape[-1] > wd for q, wd in zip(qws, widths)):
        raise ValueError(
            f"member widths {[q.codes.shape[-1] for q in qws]} exceed the "
            f"declared spans {tuple(widths)}")
    codes = torch.cat([F.pad(q.codes, (0, wd - q.codes.shape[-1]))
                       for q, wd in zip(qws, widths)], dim=-1)
    scale = torch.cat([F.pad(
        torch.broadcast_to(q.scale, (1, q.codes.shape[-1])),
        (0, wd - q.codes.shape[-1]), value=1.0)
        for q, wd in zip(qws, widths)], dim=-1)
    return QuantizedTensor(codes=codes, scale=scale, bits=bits)
