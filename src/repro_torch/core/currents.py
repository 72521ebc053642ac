"""Weight -> current-source programming (paper Eq. 5-7) and four-quadrant split.

For an N-input column with weights w_i in [0, w_max], Eq. 6 programs

    I_i = I_max * w_i / (2*w_max - mean(w))

(the paper's Eq. 6 after substituting Eq. 5, C*V_TH = N*I_max*T), and Eq. 7
adds a bias source, always on from t=0:

    I_0 = 1/2 * (N*I_max - sum_i I_i).

With these, the crossing time of the charge threshold K = C*V_TH = N*I_max*T
encodes exactly  y = sum_i w_i x_i / (N*w_max)  — weight-scale-free, which is
what allows chaining VMMs in the time domain (section 2.2).

Invariants: 0 <= I_i <= I_max (the Eq. 6 denominator lies in
[w_max, 2*w_max]) and I_0 >= 0 (since sum I_i <= N*I_max).
"""
from __future__ import annotations

import torch


def program_column(w: torch.Tensor, i_max: float,
                   w_max: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Program one column of N non-negative weights in [0, w_max].

    Returns (currents (N,), bias_current scalar)."""
    n = w.shape[0]
    denom = 2.0 * w_max - torch.mean(w)     # in [w_max, 2*w_max] -> always > 0
    currents = i_max * w / denom
    bias = 0.5 * (n * i_max - torch.sum(currents))
    return currents, bias


def program_matrix(w: torch.Tensor, i_max: float,
                   w_max: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Program a full (N_in, N_out) non-negative weight matrix column-wise.

    Returns (currents (N_in, N_out), bias (N_out,))."""
    n_in = w.shape[0]
    denom = 2.0 * w_max - torch.mean(w, dim=0)             # (N_out,)
    currents = i_max * w / denom[None, :]
    bias = 0.5 * (n_in * i_max - torch.sum(currents, dim=0))
    return currents, bias


def four_quadrant_weights(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Signed weight matrix -> (W_plus, W_minus), both >= 0, W = W_plus - W_minus.

    In the circuit each weight owns four current sources: for w > 0,
    I^{++} = I^{--} = program(w), I^{+-} = I^{-+} = 0; mirrored for w < 0
    (section 2.2).  The rectified split realizes exactly that."""
    return torch.clamp(w, min=0.0), torch.clamp(-w, min=0.0)


def four_quadrant_program(w: torch.Tensor, i_max: float,
                          w_max: float) -> dict[str, torch.Tensor]:
    """Program the four current-source arrays for a signed (N_in, N_out) matrix.

    The positive output wire integrates  x+ @ W+  +  x- @ W-  (2*N_in
    sources), the negative one  x+ @ W-  +  x- @ W+; each bias is programmed
    for its stacked column.  Returns 'pos' ((2*N_in, N_out), W+ stacked over
    W-), 'neg' (W- over W+), 'bias_pos' and 'bias_neg' ((N_out,))."""
    w_plus, w_minus = four_quadrant_weights(w)
    i_pos, b_pos = program_matrix(torch.cat([w_plus, w_minus], dim=0),
                                  i_max, w_max)
    i_neg, b_neg = program_matrix(torch.cat([w_minus, w_plus], dim=0),
                                  i_max, w_max)
    return {"pos": i_pos, "neg": i_neg, "bias_pos": b_pos, "bias_neg": b_neg}


def quantize_weights(w: torch.Tensor, weight_bits: int,
                     w_max: float) -> torch.Tensor:
    """Finite programming resolution of the FG current sources: uniform
    quantization of the magnitude to 2^weight_bits levels over [0, w_max]
    (per quadrant), rounding half to even as ``jnp.round`` does."""
    levels = float((1 << weight_bits) - 1)
    mag = torch.clamp(torch.abs(w) / w_max, 0.0, 1.0)
    mag_q = torch.round(mag * levels) / levels
    return torch.sign(w) * mag_q * w_max
