"""Plain torch versions of the threshold-crossing solve.

Both solve, per batch row b and output column n,

    Q(t) = sum_k I[k, n] * max(t - t_on[b, k], 0)  =  k_charge

the latch firing time of the charge-integration column (paper Eq. 4).

* ``crossing_exact`` is the sort-based event sweep of the JAX package's
  ``kernels/crossing/ref.crossing_ref``, batched over rows: Q is monotone
  piecewise-linear, so the segment holding k_charge gives the answer in
  closed form.  It is the oracle.
* ``crossing_plain`` is kernel B4's plain version: the bisection of the JAX
  package's ``kernels/crossing/crossing._kernel``, term for term, on
  [t_lo, t_hi].  A crossing beyond t_hi comes back as t_hi to within the
  last bracket, (t_hi - t_lo) * 2^-iters (the bisection never leaves its
  bracket), where ``crossing_exact`` extrapolates the last segment.
* ``general_steps`` counts the steps of that bisection on which B4 sums
  over K (mid below the row's last onset); ``chip_smoke.py`` prices them
  in B4's bound.
"""
from __future__ import annotations

import numpy as np
import torch

# crossing_plain's (rows, K, N) float32 temporary stays under this many bytes
PLAIN_CHUNK_BYTES = 2 << 30


def f32(v: float) -> float:
    """``v`` rounded to float32, as the kernel receives its scalars."""
    return float(np.float32(v))


def crossing_exact(t_on: torch.Tensor, currents: torch.Tensor,
                   k_charge: float) -> torch.Tensor:
    """t_on: (B, K); currents: (K, N); returns (B, N) crossing times."""
    b, k = t_on.shape
    n = currents.shape[1]
    order = torch.argsort(t_on, dim=1, stable=True)         # (B, K)
    ts = torch.gather(t_on, 1, order)                       # (B, K)
    cs = currents[order]                                    # (B, K, N)
    slope = torch.cumsum(cs, dim=1)
    moment = torch.cumsum(cs * ts[:, :, None], dim=1)
    q_at_break = slope * ts[:, :, None] - moment            # (B, K, N)
    target = torch.full((b, n, 1), f32(k_charge), dtype=q_at_break.dtype,
                        device=t_on.device)
    idx = torch.searchsorted(q_at_break.transpose(1, 2).contiguous(), target,
                             right=True) - 1                # (B, N, 1)
    idx = torch.clamp(idx, 0, k - 1).transpose(1, 2)        # (B, 1, N)
    sl = torch.gather(slope, 1, idx)[:, 0]
    mo = torch.gather(moment, 1, idx)[:, 0]
    return (k_charge + mo) / torch.clamp(sl, min=1e-30)


def crossing_plain(t_on: torch.Tensor, currents: torch.Tensor,
                   k_charge: float, t_lo: float = 0.0, t_hi: float = 1.0,
                   iters: int = 24) -> torch.Tensor:
    """B4's bisection in torch ops, on rows in chunks.  t_on (B, K) and
    currents (K, N) float32; returns (B, N) float32."""
    return _bisect(t_on, currents, k_charge, t_lo, t_hi, iters)[0]


def general_steps(t_on: torch.Tensor, currents: torch.Tensor,
                  k_charge: float, t_lo: float = 0.0, t_hi: float = 1.0,
                  iters: int = 24) -> int:
    """The (row, column, step) triples of ``crossing_plain``'s bisection
    whose mid lies below the row's last onset: the steps on which kernel B4
    sums the relus over K (at every other step Q is linear in mid).  B4's
    brackets may part from the plain version's where Q(mid) lies within
    rounding of the charge, so this counts the plain trajectory's steps."""
    return _bisect(t_on, currents, k_charge, t_lo, t_hi, iters, True)[1]


def _bisect(t_on, currents, k_charge, t_lo, t_hi, iters, count=False):
    b, k = t_on.shape
    n = currents.shape[1]
    k_charge, t_lo, t_hi = f32(k_charge), f32(t_lo), f32(t_hi)
    out = torch.empty((b, n), dtype=torch.float32, device=t_on.device)
    general = 0
    rows = max(1, PLAIN_CHUNK_BYTES // max(4 * k * n, 1))
    for r0 in range(0, b, rows):
        t = t_on[r0:r0 + rows]
        t_max = t.max(dim=1, keepdim=True).values if count and k else None
        lo = torch.full((t.shape[0], n), t_lo, dtype=torch.float32,
                        device=t.device)
        hi = torch.full_like(lo, t_hi)
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            if t_max is not None:
                general += int((mid < t_max).sum())
            # Q(mid) per column: sum_k I[k,n] * relu(mid[n] - t_on[k]);
            # the (rows, K, N) temporary is updated in place
            dt = torch.clamp_(mid[:, None, :] - t[:, :, None], min=0.0)
            q = torch.sum(dt.mul_(currents), dim=1)
            too_low = q < k_charge
            lo = torch.where(too_low, mid, lo)
            hi = torch.where(too_low, hi, mid)
        out[r0:r0 + t.shape[0]] = 0.5 * (lo + hi)
    return out, general
