"""Event-driven time-domain VMM core (paper sections 2.1-2.2, 3.1).

The behavioral simulator: it programs weights into current sources, encodes
inputs as turn-on times, integrates charge on each output wire and finds the
latch's threshold-crossing time, rather than assuming the closed-form
result.  It reproduces the closed form  y = sum_i w_i x_i / (N w_max)
(Eq. 1), the paper's central identity, to float32 rounding.

Every VMM solves its output wires' crossings in one launch of kernel B4
(``kernels/crossing``): the wires of a differential pair share their input
onsets, so their currents sit side by side, (K, 2 N_out), with the bias
source as the last row at onset 0.  A tensor on the card goes to B4, a CPU
tensor to its plain version.  The JAX package solves each column with its
own exact sort-based ``crossing_time`` (here ``crossing_time``, for one
column); the bisection over [0, 2T] agrees with it to T * 2^-24 plus the
charge sum's rounding.

Each VMM takes x as (N_in,) or (B, N_in): the batch is a leading dimension,
not a vmap.
"""
from __future__ import annotations

import torch

from repro_torch.core import currents as cur
from repro_torch.core import encoding as enc
from repro_torch.core.constants import TAU_F_S, TAU_RESET_S, TDVMMSpec
from repro_torch.kernels.crossing import ops as crossing_ops
from repro_torch.kernels.crossing.ref import crossing_exact


# --------------------------------------------------------------------------
# Threshold-crossing solvers
# --------------------------------------------------------------------------
def crossing_time(t_on: torch.Tensor, i_src: torch.Tensor,
                  k_charge: float) -> torch.Tensor:
    """Exact crossing time of  Q(t) = sum_i I_i * max(t - t_i, 0)  with
    Q(t*) = K, for one column: t_on and i_src (M,); returns a scalar."""
    return crossing_exact(t_on[None, :], i_src[:, None], k_charge)[0, 0]


def with_bias_source(t_on: torch.Tensor, i_mat: torch.Tensor,
                     i_bias: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """B4's operands for a programmed array: onsets (B, N_in + 1) and
    currents (N_in + 1, N_out), float32, with the bias source (always on
    from t=0, Eq. 7) as the last row.  t_on: (B, N_in); i_mat: (N_in,
    N_out); i_bias: (N_out,)."""
    t = t_on.to(torch.float32)
    t_full = torch.cat([t, torch.zeros((t.shape[0], 1), dtype=t.dtype,
                                       device=t.device)], dim=1)
    i_full = torch.cat([i_mat, i_bias[None, :]], dim=0).to(torch.float32)
    return t_full, i_full


def _column_crossings(t_on: torch.Tensor, i_mat: torch.Tensor,
                      i_bias: torch.Tensor, k_charge: float,
                      t_window: float) -> torch.Tensor:
    """Crossing times of every output column of a programmed array, in one
    B4 launch.  t_on: (..., N_in); i_mat: (N_in, N_out); i_bias: (N_out,).
    Returns (..., N_out) times in [0, 2T]."""
    lead, n_in = t_on.shape[:-1], t_on.shape[-1]
    t_full, i_full = with_bias_source(t_on.reshape(-1, n_in), i_mat, i_bias)
    out = crossing_ops.crossing_times(t_full, i_full, k_charge, t_window)
    return out.reshape(*lead, i_mat.shape[1])


def _decode_pair(t: torch.Tensor, n_out: int, t_window: float):
    """Split side-by-side (+, -) wire times; the differential output."""
    t_plus, t_minus = t[..., :n_out], t[..., n_out:]
    y = enc.crossing_to_value(t_plus, t_window) \
        - enc.crossing_to_value(t_minus, t_window)
    return y, (t_plus, t_minus)


# --------------------------------------------------------------------------
# Single-quadrant dot product / VMM (section 2.1)
# --------------------------------------------------------------------------
def td_vmm_single_quadrant(x: torch.Tensor, w: torch.Tensor,
                           spec: TDVMMSpec) -> torch.Tensor:
    """Simulate the single-quadrant VMM: x in [0,1]^(N_in), w in
    [0,w_max]^(N_in,N_out).  Returns the decoded  y = (w^T x) / (N_in w_max)
    as recovered from the simulated crossing times (Eq. 1-7)."""
    n_in = x.shape[-1]
    t_window = spec.t_window_s
    i_mat, i_bias = cur.program_matrix(w, spec.i_max, spec.w_max)
    k_charge = spec.v_th_charge(n_in)           # K = N * I_max * T  (Eq. 5)
    t_on = enc.value_to_onset(x, t_window)
    t_cross = _column_crossings(t_on, i_mat, i_bias, k_charge, t_window)
    return enc.crossing_to_value(t_cross, t_window)


def ideal_single_quadrant(x: torch.Tensor, w: torch.Tensor,
                          w_max: float) -> torch.Tensor:
    """Closed-form Eq. 1 for the single-quadrant VMM."""
    return (x @ w) / (x.shape[-1] * w_max)


# --------------------------------------------------------------------------
# Four-quadrant VMM (section 2.2) and two-quadrant variant (section 3.1)
# --------------------------------------------------------------------------
def four_quadrant_operands(x: torch.Tensor, w: torch.Tensor,
                           spec: TDVMMSpec):
    """(t_on (..., 2 N_in), currents (2 N_in, 2 N_out), bias (2 N_out,),
    k_charge) of the four-quadrant VMM: onsets of the x+ then the x- wires;
    the + wire's currents (W+ stacked over W-) beside the - wire's (W- over
    W+), which share those onsets."""
    n_in = w.shape[0]
    x_p, x_m = enc.four_quadrant_split(x)
    prog = cur.four_quadrant_program(w, spec.i_max, spec.w_max)
    t_on = torch.cat([enc.value_to_onset(x_p, spec.t_window_s),
                      enc.value_to_onset(x_m, spec.t_window_s)], dim=-1)
    return (t_on, torch.cat([prog["pos"], prog["neg"]], dim=1),
            torch.cat([prog["bias_pos"], prog["bias_neg"]]),
            spec.v_th_charge(2 * n_in))


def td_vmm_four_quadrant(x: torch.Tensor, w: torch.Tensor, spec: TDVMMSpec,
                         return_times: bool = False):
    """Simulate the differential four-quadrant VMM.

    x: (..., N_in) signed, |x| <= 1.  w: (N_in, N_out) signed, |w| <= w_max.
    Each output wire of the +/- pair integrates 2*N_in current sources (W+
    stacked over W-, section 2.2), so the decoded differential output is
    y = (w^T x) / (2 N_in w_max).  Returns y (..., N_out), and optionally
    the raw (t_plus, t_minus) crossing times (for the ReLU AND gate)."""
    t = _column_crossings(*four_quadrant_operands(x, w, spec),
                          spec.t_window_s)
    y, times = _decode_pair(t, w.shape[1], spec.t_window_s)
    return (y, times) if return_times else y


def ideal_four_quadrant(x: torch.Tensor, w: torch.Tensor,
                        w_max: float) -> torch.Tensor:
    return (x @ w) / (2.0 * x.shape[-1] * w_max)


def two_quadrant_operands(x: torch.Tensor, w: torch.Tensor,
                          spec: TDVMMSpec):
    """(t_on (..., N_in), currents (N_in, 2 N_out), bias (2 N_out,),
    k_charge) of the two-quadrant VMM: the + wire's currents (W+) beside
    the - wire's (W-)."""
    w_p, w_m = cur.four_quadrant_weights(w)
    i_pos, b_pos = cur.program_matrix(w_p, spec.i_max, spec.w_max)
    i_neg, b_neg = cur.program_matrix(w_m, spec.i_max, spec.w_max)
    t_on = enc.value_to_onset(torch.clamp(x, 0.0, 1.0), spec.t_window_s)
    return (t_on, torch.cat([i_pos, i_neg], dim=1), torch.cat([b_pos, b_neg]),
            spec.v_th_charge(w.shape[0]))


def td_vmm_two_quadrant(x: torch.Tensor, w: torch.Tensor, spec: TDVMMSpec,
                        return_times: bool = False):
    """Two-quadrant VMM: non-negative inputs, signed weights (section 3.1
    end).  The four-quadrant design without its negative input wires: each
    output wire integrates N_in sources, so y = (w^T x) / (N_in w_max)."""
    t = _column_crossings(*two_quadrant_operands(x, w, spec),
                          spec.t_window_s)
    y, times = _decode_pair(t, w.shape[1], spec.t_window_s)
    return (y, times) if return_times else y


def ideal_two_quadrant(x: torch.Tensor, w: torch.Tensor,
                       w_max: float) -> torch.Tensor:
    return (x @ w) / (x.shape[-1] * w_max)


# --------------------------------------------------------------------------
# Time-domain ReLU (the AND gate of Fig. 2c) and chaining
# --------------------------------------------------------------------------
def relu_duration(t_plus: torch.Tensor, t_minus: torch.Tensor) -> torch.Tensor:
    """The rectify-linear AND gate: a pulse of duration t_minus - t_plus
    when the + latch fires first (positive output), zero otherwise (Fig. 1d
    / 2c)."""
    return torch.clamp(t_minus - t_plus, min=0.0)


def td_mlp_forward(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                   spec: TDVMMSpec) -> torch.Tensor:
    """Two-layer perceptron computed fully in the time domain (Fig. 2):
    a four-quadrant VMM, the AND-gate ReLU (pulse-duration-encoded hidden
    activations, section 3.1), a two-quadrant VMM; two B4 launches.

    The ideal reference is  h = relu(x @ w1) / (2 N_in w_max);
    y = (h @ w2) / (N_h w_max)."""
    t_window = spec.t_window_s
    _, (t1p, t1m) = td_vmm_four_quadrant(x, w1, spec, return_times=True)
    # the AND-gate pulse duration encodes h in [0, T]; as charge it is
    # equivalent to a rising-edge input of value h (equal total on-time)
    h = enc.duration_to_value(relu_duration(t1p, t1m), t_window)
    return td_vmm_two_quadrant(h, w2, spec)


def ideal_mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
              w_max: float) -> torch.Tensor:
    h = torch.relu(ideal_four_quadrant(x, w1, w_max))
    return ideal_two_quadrant(h, w2, w_max)


# --------------------------------------------------------------------------
# Pipelined operation (Fig. 2d)
# --------------------------------------------------------------------------
def pipeline_schedule(n_stages: int, n_samples: int,
                      spec: TDVMMSpec) -> dict[str, float]:
    """Timing of the two-phase pipelined schedule (Fig. 2d).

    Each stage computes during phase I ([0,T]) and reads out during phase II
    ([T,2T]); phase II of stage l *is* phase I of stage l+1.  New samples
    are admitted every 2T + tau_reset."""
    t = spec.t_window_s
    period = 2.0 * t + TAU_RESET_S
    first_out = (n_stages + 1) * t + n_stages * TAU_F_S
    total = (n_samples - 1) * period + first_out
    return {
        "period_s": period,
        "first_output_s": first_out,
        "total_s": total,
        "throughput_samples_per_s": 1.0 / period,
    }
