"""Time-domain encoding of values (paper Eq. 2-3 and the pulse-duration variant).

Normalized values live in [0, 1].  A value ``x`` is encoded as the turn-on
time ``t_on = T * (1 - x)`` inside the input window [0, T] (rising-edge
encoding, Eq. 2); the dot-product output is the latch crossing time
``T + t_sigma`` in [T, 2T] (Eq. 3), decoded as ``y = (T - t_sigma) / T``.
Section 3.1's pulse-duration encoding, used between chained VMMs where the
ReLU AND gate emits a pulse of duration d, is equivalent: ``x = d / T``.

A p-bit digital I/O converter realizes t_on on a grid of 2^p slots: the
integer time codes.  The rounding is ``torch.round`` — round half to even,
like ``jnp.round`` — so codes are bitwise those of the JAX package.
"""
from __future__ import annotations

import torch


def quantize_code(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Normalized value in [0,1] -> integer time code in {0, ..., 2^p - 1}.

    Code k represents the value k / (2^p - 1); this is the digital word the
    shared-counter DAC compares against.
    """
    levels = float((1 << bits) - 1)
    return torch.round(torch.clamp(x, 0.0, 1.0) * levels).to(torch.int32)


def quantize_code_signed(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Signed value in [-1, 1] -> signed integer code in {-L, ..., L}.

    The sign carries the differential (+,-) wire pair of the four-quadrant
    multiplier (section 2); |code| is the unsigned p-bit time code.
    """
    return torch.sign(x).to(torch.int32) * quantize_code(torch.abs(x), bits)


def dequantize_code(code: torch.Tensor, bits: int) -> torch.Tensor:
    levels = float((1 << bits) - 1)
    return code.to(torch.float32) / levels


def fake_quant(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Round-trip through the p-bit time grid (value domain)."""
    return dequantize_code(quantize_code(x, bits), bits)


def value_to_onset(x: torch.Tensor, t_window: float) -> torch.Tensor:
    """x in [0,1] -> rising-edge time t_on in [0, T]  (Eq. 2: T - t_i ~ x_i)."""
    return t_window * (1.0 - torch.clamp(x, 0.0, 1.0))


def onset_to_value(t_on: torch.Tensor, t_window: float) -> torch.Tensor:
    return 1.0 - t_on / t_window


def crossing_to_value(t_cross: torch.Tensor, t_window: float) -> torch.Tensor:
    """Latch crossing time (absolute, in [T, 2T]) -> output value (Eq. 3)."""
    t_sigma = t_cross - t_window
    return 1.0 - t_sigma / t_window


def value_to_duration(x: torch.Tensor, t_window: float) -> torch.Tensor:
    """Pulse-duration encoding (section 3.1): x in [0,1] -> pulse length in [0,T]."""
    return t_window * torch.clamp(x, 0.0, 1.0)


def duration_to_value(d: torch.Tensor, t_window: float) -> torch.Tensor:
    return d / t_window


def four_quadrant_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Signed value -> differential (positive-wire, negative-wire) pair,
    the canonical rectified split: x = x_plus - x_minus."""
    return torch.clamp(x, min=0.0), torch.clamp(-x, min=0.0)


def four_quadrant_merge(x_plus: torch.Tensor, x_minus: torch.Tensor) -> torch.Tensor:
    return x_plus - x_minus
