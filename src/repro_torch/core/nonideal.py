"""Non-ideality models (paper section 4.1, Fig. 4).

The dominant precision limiter is DIBL: the subthreshold drain current of the
FG cell depends on the drain-line voltage, which swings by Delta_V_D during
integration.  The paper quantifies it as

    Error = |I(V_RESET) - I(V_RESET - Delta_V_D)| / I(V_RESET)

measured over (I_max, V_SG, V_D).  The behavioral subthreshold model below
reproduces the measured trends of Fig. 4; constants marked [fitted] are
calibrated to the paper's anchor points:

  * a distinct optimum at V_SG ~ 0.8 V,
  * error decreasing with I_max up to ~1 uA, bounded above by the exit from
    the subthreshold regime,
  * Error < 2% at the optimum  =>  >= 5-6 bit computing precision.

Weight-tuning noise and S-R latch V_TH mismatch are modeled as in section
4.1.  The random draws take a ``torch.Generator`` on the device of the
tensor they perturb; they are not the JAX package's ``jax.random`` bits.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.constants import (
    DELTA_VD,
    I_MAX_OPT,
    TDVMMSpec,
    V_RESET,
    V_SG_OPT,
    V_T_THERMAL,
    VTH_MISMATCH_RMS,
)


@dataclasses.dataclass(frozen=True)
class NonIdealityConfig:
    dibl: bool = True
    weight_noise: bool = True
    sigma_tune: float = 0.003        # relative FG tuning accuracy (ref [15], ~8 bit)
    compensate_systematic: bool = True  # re-tuning removes input-independent error


# --- DIBL behavioral model ---------------------------------------------------
# [fitted] constants calibrated to Fig. 4 anchors (see module docstring).
_LAMBDA_OPT = 0.105      # DIBL coefficient at (I_max=1uA, V_SG=0.8) [1/V]
_VSG_CURVATURE = 25.0    # (1 + c*(V_SG-0.8)^2): ~2x error 0.2 V away from optimum
_I_EXPONENT = 0.36       # error ~ (I_ref/I)^beta below the optimum
_I_SUB_EDGE = 3.0e-6     # upper edge of subthreshold conduction [A]
_EDGE_SHARPNESS = 4.0


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def dibl_lambda(i_max, v_sg) -> torch.Tensor:
    """Effective DIBL coefficient lambda(I, V_SG) [1/V]."""
    i_max, v_sg = _f32(i_max), _f32(v_sg)
    vsg_term = 1.0 + _VSG_CURVATURE * (v_sg - V_SG_OPT) ** 2
    i_term = (I_MAX_OPT / torch.clamp(i_max, min=1e-12)) ** _I_EXPONENT
    # leaving subthreshold: sensitivity blows up as I approaches the edge
    edge = 1.0 + (torch.clamp(i_max, min=1e-12) / _I_SUB_EDGE) ** _EDGE_SHARPNESS
    return _LAMBDA_OPT * vsg_term * i_term * edge


def drain_current(i_prog, v_d, lam) -> torch.Tensor:
    """Subthreshold drain current vs drain voltage:
    I(V_D) = I_prog * (1 - exp(-V_D / V_T)) * (1 + lambda*V_D), normalized so
    that I(V_RESET) = I_prog."""
    i_prog, v_d, lam = _f32(i_prog), _f32(v_d), _f32(lam)
    shape = (1.0 - torch.exp(-v_d / V_T_THERMAL)) * (1.0 + lam * v_d)
    norm = (1.0 - torch.exp(_f32(-V_RESET / V_T_THERMAL))) \
        * (1.0 + lam * V_RESET)
    return i_prog * shape / norm


def relative_error(i_max, v_sg, delta_vd) -> torch.Tensor:
    """The paper's Error metric (Fig. 4):
    |I(V_RESET) - I(V_RESET - dV)| / I(V_RESET)."""
    lam = dibl_lambda(i_max, v_sg)
    i_hi = drain_current(i_max, V_RESET, lam)
    i_lo = drain_current(i_max, V_RESET - _f32(delta_vd), lam)
    return torch.abs(i_hi - i_lo) / torch.clamp(i_hi, min=1e-30)


def effective_bits(err) -> torch.Tensor:
    """Precision: number of distinguishable levels, log2(1/err), floored
    (Error < 2%  =>  'at least 5 bits', as the paper counts)."""
    return torch.floor(-torch.log2(torch.clamp(_f32(err), min=1e-12)))


# --- Applying non-idealities to programmed currents --------------------------
def perturb_currents(i_mat: torch.Tensor, generator: torch.Generator,
                     spec: TDVMMSpec, cfg: NonIdealityConfig) -> torch.Tensor:
    """Return the *effective* currents seen during integration.

    DIBL: a multiplicative perturbation uniform in [-Error, +Error] per
    source (input-dependent through the crossing time, the one error the
    paper says cannot be compensated), plus a systematic shift toward lower
    current unless ``compensate_systematic``.  Weight noise: lognormal
    relative tuning error of ref [15].  ``generator`` lives on i_mat's
    device."""
    eff = i_mat
    if cfg.dibl:
        err = float(relative_error(spec.i_max, spec.v_sg, spec.delta_vd))
        u = torch.rand(i_mat.shape, generator=generator, device=i_mat.device,
                       dtype=i_mat.dtype) * 2.0 - 1.0
        if not cfg.compensate_systematic:
            u = u + 0.5  # un-compensated systematic shift toward lower current
        eff = eff * (1.0 + err * u)
    if cfg.weight_noise:
        eff = eff * torch.exp(cfg.sigma_tune * torch.randn(
            i_mat.shape, generator=generator, device=i_mat.device,
            dtype=i_mat.dtype))
    return eff


def latch_time_offset(generator: torch.Generator, shape: tuple[int, ...],
                      n_inputs: int, spec: TDVMMSpec,
                      device=None) -> torch.Tensor:
    """Crossing-time offset from S-R latch V_TH mismatch (20 mV rms):
    delta_t = C * delta_V / I_slope with I_slope ~ N*I_max at the crossing;
    compensable by bias re-tuning (section 4.1)."""
    c_total = spec.c_total_f(n_inputs)
    dv = VTH_MISMATCH_RMS * torch.randn(shape, generator=generator,
                                        device=device)
    return c_total * dv / (n_inputs * spec.i_max)
