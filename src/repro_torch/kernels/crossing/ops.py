"""Full TD-VMM column readout through the crossing solver."""
from __future__ import annotations

import torch

from repro_torch.kernels.crossing.crossing import crossing_kernel
from repro_torch.kernels.crossing.ref import crossing_exact


def crossing_times(t_on: torch.Tensor, currents: torch.Tensor,
                   k_charge: float, t_window: float,
                   iters: int = 24) -> torch.Tensor:
    """Latch firing times in [0, 2T] for every (batch row, output column):
    kernel B4 for tensors on the card, its plain version on the CPU."""
    return crossing_kernel(t_on, currents, k_charge, t_lo=0.0,
                           t_hi=2.0 * t_window, iters=iters)


def crossing_times_exact(t_on: torch.Tensor, currents: torch.Tensor,
                         k_charge: float) -> torch.Tensor:
    """The sort-based exact solve (``ref.crossing_exact``, the oracle),
    exposed beside the bisection."""
    return crossing_exact(t_on, currents, k_charge)
