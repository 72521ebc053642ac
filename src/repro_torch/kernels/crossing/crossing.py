"""Kernel B4, the latch threshold-crossing solver, for Hopper; a launch
counter.

B4 (``csrc/crossing.cu``) replaces the Pallas ``crossing._kernel``
(``repro/kernels/crossing/crossing.py``): per (batch row, output column) it
runs ``iters`` bisection steps of the monotone
``Q(t) = sum_k I[k, n] * relu(t - t_on[b, k])`` against ``k_charge`` on
[t_lo, t_hi] and returns the middle of the last bracket.  Its plain version
is ``ref.crossing_plain``.

The kernel takes the same brackets but evaluates Q another way where that
is exact: for mid at or past the row's last onset every relu is the
identity, so Q(mid) = mid * S[n] - M[b, n] with S the column sums and
M = t_on @ I, one product on the tensor cores in 3xTF32; below the last
onset it sums the relus over K.  ``crossing_kernel`` counts one launch per
call, whatever number of device kernels it runs (a prep kernel for the row
maxima and column sums, then the fused product and bisection).

``crossing_kernel`` follows the port's one rule: a CPU tensor goes to the
plain version, a tensor on the card to the kernel or an exception.  The
kernel rounds Q otherwise than the plain version, so where Q(mid) lies
within that rounding of k_charge the two may take different halves; both
still bracket the crossing, so they agree within about t_hi * 2^-iters plus
the rounding over Q's slope, not bitwise.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build, hooks
from repro_torch.kernels.crossing.ref import crossing_plain, f32

CSRC = Path(__file__).parent / "csrc"

LAUNCHES = {"crossing": 0}

# the kernel's CTA tile is 64 rows: the grid's second axis holds B / 64
MAX_ROWS = 65535 * 64


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.crossing_b4.argtypes = [vp, vp, vp, vp, i, i, i, f, f, f, i, vp]
    lib.crossing_b4.restype = i


# no --use_fast_math: IEEE float32 adds, products and fmaxf
LIBRARIES = {"b4": _build.Library("crossing_b4", CSRC / "crossing.cu", (),
                                  _bind)}


def _check(t_on: torch.Tensor, currents: torch.Tensor, iters: int) -> None:
    if t_on.dim() != 2 or currents.dim() != 2 \
            or t_on.shape[1] != currents.shape[0]:
        raise ValueError(f"crossing: t_on (B, K) and currents (K, N), got "
                         f"{tuple(t_on.shape)} and {tuple(currents.shape)}")
    if t_on.device != currents.device:
        raise ValueError(f"crossing: operands on {t_on.device} and "
                         f"{currents.device}")
    if t_on.dtype != torch.float32 or currents.dtype != torch.float32:
        raise ValueError(f"crossing: float32 operands, got {t_on.dtype} and "
                         f"{currents.dtype}")
    if iters < 0:
        raise ValueError(f"crossing: iters >= 0, got {iters}")


def crossing_kernel(t_on: torch.Tensor, currents: torch.Tensor,
                    k_charge: float, t_lo: float = 0.0, t_hi: float = 1.0,
                    iters: int = 24) -> torch.Tensor:
    """B4: latch firing times (B, N) float32 for onsets t_on (B, K) and
    currents (K, N), both float32, by ``iters`` bisection steps on
    [t_lo, t_hi].  A crossing beyond t_hi comes back as t_hi to within
    the last bracket."""
    _check(t_on, currents, iters)
    with hooks.call("crossing", b=t_on.shape[0], k=t_on.shape[1],
                    n=currents.shape[1]):
        return _solve(t_on, currents, k_charge, t_lo, t_hi, iters)


def _solve(t_on: torch.Tensor, currents: torch.Tensor, k_charge: float,
           t_lo: float, t_hi: float, iters: int) -> torch.Tensor:
    if t_on.device.type == "cpu" and not hooks.is_fake(t_on):
        return crossing_plain(t_on, currents, k_charge, t_lo, t_hi, iters)
    if not hooks.card_route(t_on):
        raise ValueError(f"crossing_kernel runs on cuda (or plain on cpu), "
                         f"got {t_on.device}")
    b, k = t_on.shape
    n = currents.shape[1]
    if b > MAX_ROWS or k >= 1 << 31 or n >= 1 << 31:
        raise ValueError(f"crossing: B = {b} (at most {MAX_ROWS}), K = {k} "
                         f"and N = {n} (below 2^31)")
    t_on, currents = t_on.contiguous(), currents.contiguous()
    out = torch.empty((b, n), dtype=torch.float32, device=t_on.device)
    if b == 0 or n == 0 or hooks.is_fake(t_on):
        return out
    # the prep kernel's row maxima (B) and column sums (N)
    scratch = torch.empty(b + n, dtype=torch.float32, device=t_on.device)
    err = _build.load(LIBRARIES["b4"]).crossing_b4(
        t_on.data_ptr(), currents.data_ptr(), scratch.data_ptr(),
        out.data_ptr(), b, k, n,
        f32(k_charge), f32(t_lo), f32(t_hi), iters,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check_launch(err, f"crossing_kernel (B={b}, K={k}, N={n})")
    LAUNCHES["crossing"] += 1
    return out
