"""Time-domain encoding of values (paper Eq. 2-3): the p-bit code grid.

Only what ``core/quant.py`` needs is ported: normalized values in [0, 1]
(or signed values in [-1, 1]) to integer time codes.  The rounding is
``torch.round`` — round half to even, like ``jnp.round`` — so codes are
bitwise those of the JAX package.
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
