"""Public TD-VMM ops: integrate + readout epilogue on integer codes.

The torch counterpart of ``repro.kernels.tdvmm.ops``:

    acc = x_codes @ w_codes          charge accumulation (Eq. 1)
    z   = acc * gain                 latch normalization (crossing time)
    z   = readout(z, out_bits)       p-bit shared-counter ADC (Eq. 3, §4.2)
    y   = z * x_scale[:, None] * w_scale[None, :]   digital rescale

Backends: ``"auto"`` (and ``"pallas"``, the JAX package's name for its
kernel) resolve to the ``"cuda"`` route — the hand-written kernels of
``tdvmm`` for a tensor on the card, their plain versions for a CPU tensor.
``"jnp"`` is the plain version chosen explicitly (exact integer
accumulation + ``_epilogue``).  Every route evaluates the same expression
term for term, so all are bitwise equal to each other and to the JAX
package's ``backend="jnp"``.

Epilogue placement on the cuda route: a fixed readout window (``out_scale``
or the runtime ``out_window`` operand) or no readout runs fused in B1; a
data-calibrated window (``out_scale=None`` with ``out_bits``) runs B2
(``fused_calibration=False`` keeps the two-pass form: B1 raw + ``_epilogue``).

Only int8 codes are ported; ragged grouped launches (``group_widths``) wait
for ``td_grouped_matmul``'s slice.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.tdvmm import tdvmm


def resolve_backend(backend: str) -> str:
    """'auto' | 'pallas' | 'cuda' -> 'cuda'; 'jnp' -> 'jnp'."""
    if backend in ("auto", "pallas", "cuda"):
        return "cuda"
    if backend != "jnp":
        raise ValueError(f"unknown TD-VMM backend {backend!r}")
    return backend


def _f32(v, device) -> torch.Tensor:
    """A float32 scalar (or (E,) tuple) as a tensor on ``device``; a scalar
    is filled on the device, with no host-to-device copy."""
    if isinstance(v, tuple):
        return torch.from_numpy(np.asarray(v, np.float32)).to(device)
    return torch.full((), float(np.float32(v)), dtype=torch.float32,
                      device=device)


# ---------------------------------------------------------------------------
# Epilogue (unfused form; the kernels mirror this term for term)
# ---------------------------------------------------------------------------
def _epilogue(acc, x_scale, w_scale, gain, out_bits, out_scale,
              out_window=None):
    """gain -> optional p-bit readout -> per-row x per-channel rescale.

    acc: (E, M, N) int32, non-empty; x_scale: (E|1, M); w_scale: (E, N).
    ``out_scale=None`` calibrates the ADC window to max|z| *per expert tile*;
    a tuple is an (E,)-vector of fixed per-expert windows; ``out_window`` is
    the tensor form of a fixed window (scalar or (E,)) — the serving engine's
    runtime operand."""
    s = None
    if out_bits is not None:
        dev = acc.device
        if out_window is not None:
            ow = out_window.to(device=dev, dtype=torch.float32)
            s = ow.reshape(-1, 1, 1) if ow.dim() >= 1 else ow
        elif out_scale is None:
            z = acc.to(torch.float32) * _f32(gain, dev)
            s = torch.maximum(
                torch.amax(torch.abs(z), dim=(-2, -1), keepdim=True),
                _f32(1e-9, dev))
        elif isinstance(out_scale, tuple):
            s = _f32(out_scale, dev).reshape(-1, 1, 1)
        else:
            s = _f32(out_scale, dev)
    return tdvmm.epilogue_plain(acc, x_scale, w_scale, gain, out_bits, s)


def _calib_slots(e: int, n: int, bn: int,
                 group_widths) -> tuple[torch.Tensor, int]:
    """(slots, nslots) for the calibrated kernel: the readout-slot id of
    every ``bn``-wide column block — the expert id for batched launches, the
    group member owning the span for ragged launches (pad-tail blocks fold
    into the last member; their zero accumulators can't move an abs-max)."""
    bn = min(bn, n)
    nn = -(-n // bn)
    if group_widths is None:
        ids = torch.arange(e, dtype=torch.int32)[:, None].expand(e, nn)
        return ids.contiguous(), e
    bounds = np.cumsum(group_widths)
    ids = np.searchsorted(bounds, np.arange(nn) * bn, side="right")
    ids = np.minimum(ids, len(group_widths) - 1).astype(np.int32)
    return torch.from_numpy(ids[None, :]), len(group_widths)


def _tdvmm_impl(x_codes, w_codes, x_scale, w_scale, gain, out_bits,
                out_scale, out_window, backend, code_dtype,
                fused_calibration):
    ex, m, k = x_codes.shape
    e, _, n = w_codes.shape
    if min(e, m, k, n) == 0:
        # zero charge everywhere, and readout(0) * scales == 0 on every path
        return torch.zeros((e, m, n), dtype=torch.float32,
                           device=x_codes.device)
    if code_dtype != "int8":
        raise NotImplementedError(
            f"{code_dtype!r} codes are not ported yet (B1's remaining modes: "
            "f32 and int4-packed codes)")
    xi = x_codes.to(torch.int8).contiguous()
    wi = w_codes.to(torch.int8).contiguous()

    if backend == "jnp":
        return _epilogue(tdvmm.acc_plain(xi, wi), x_scale, w_scale, gain,
                         out_bits, out_scale, out_window)
    if out_bits is None or out_scale is not None or out_window is not None:
        window = None
        if out_bits is not None:
            if out_window is not None:
                window = out_window.to(device=xi.device, dtype=torch.float32)
            else:
                window = _f32(out_scale, xi.device)
        return tdvmm.tdvmm_fused(xi, wi, x_scale, w_scale, gain, out_bits,
                                 window)
    if fused_calibration:
        slots, nslots = _calib_slots(e, n, tdvmm.TILE_N, None)
        return tdvmm.tdvmm_calibrated(
            xi, wi, x_scale, w_scale, slots.to(xi.device), nslots,
            min(tdvmm.TILE_N, n), gain, out_bits)
    acc = tdvmm.tdvmm_matmul_raw(xi, wi)
    return _epilogue(acc, x_scale, w_scale, gain, out_bits, out_scale,
                     out_window)


def codes_matmul(x_codes: torch.Tensor, w_codes: torch.Tensor,
                 backend: str, code_dtype: str = "auto") -> torch.Tensor:
    """Raw (.., M, K) @ (.., K, N) charge accumulation as f32 (B1 raw mode
    on the cuda route).  A 2-D x against a 3-D (G, K, N) bank runs shared-x:
    one code matrix against G tiles, returning (G, M, N) (no squeeze)."""
    squeeze = x_codes.dim() == 2 and w_codes.dim() == 2
    x3 = x_codes[None] if x_codes.dim() == 2 else x_codes
    w3 = w_codes[None] if w_codes.dim() == 2 else w_codes
    if code_dtype == "auto":
        code_dtype = "int8" if not x3.dtype.is_floating_point else "f32"
    if code_dtype != "int8":
        raise NotImplementedError(
            f"{code_dtype!r} codes are not ported yet (B1's remaining modes)")
    xi = x3.to(torch.int8).contiguous()
    wi = w3.to(torch.int8).contiguous()
    if resolve_backend(backend) == "jnp":
        acc = tdvmm.acc_plain(xi, wi)
    else:
        acc = tdvmm.tdvmm_matmul_raw(xi, wi)
    acc = acc.to(torch.float32)
    return acc[0] if squeeze else acc


def tdvmm_matmul(
    x_codes: torch.Tensor,      # (M, K) or (E, M, K) signed time codes
    w_codes: torch.Tensor,      # (K, N) or (E, K, N) signed weight codes
    x_scale: torch.Tensor,      # (M,) / (E, M) per-row input scales
    w_scale: torch.Tensor,      # (N,) / (E, N) per-channel weight scales
    gain: float = 1.0,
    out_bits: Optional[int] = None,
    out_scale: float | tuple[float, ...] | None = None,
    backend: str = "auto",
    code_dtype: str = "auto",
    group_widths: Optional[tuple[int, ...]] = None,
    fused_calibration: bool = True,
    out_window: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Quantized four-quadrant TD-VMM: codes matmul + readout + scale epilogue.

    ``out_scale=None`` calibrates the readout window from the data (§3.1);
    a float or an (E,)-tuple pins it.  ``out_window`` is the tensor form of
    a fixed window — scalar or per-expert (E,) — bitwise interchangeable with
    ``out_scale``.  Shared-x: a 2-D (M, K) x against a 3-D (G, K, N) bank
    returns (G, M, N) un-squeezed.
    """
    backend = resolve_backend(backend)
    squeeze = x_codes.dim() == 2 and w_codes.dim() == 2
    if x_codes.dim() == 2:
        x_codes = x_codes[None]
    if w_codes.dim() == 2:
        w_codes = w_codes[None]
    ex, m, _ = x_codes.shape
    e, _, n = w_codes.shape
    if ex not in (e, 1):
        raise ValueError(
            f"batched x/w mismatch: x batch {ex} vs w batch {e} "
            "(shared-x grouped launches carry a single x batch entry)")
    if group_widths is not None:
        raise NotImplementedError(
            "ragged grouped launches (group_widths) are not ported yet")
    if isinstance(out_scale, tuple) and len(out_scale) != e:
        raise ValueError(
            f"out_scale has {len(out_scale)} per-expert windows for "
            f"E={e} batched tiles")
    if out_window is not None:
        if out_bits is None:
            raise ValueError("out_window needs out_bits (p-bit readout)")
        if out_scale is not None:
            raise ValueError(
                "out_window and out_scale are mutually exclusive (the "
                "window tensor is the runtime-operand form of out_scale)")
        if out_window.dim() == 1 and out_window.shape[0] != e:
            raise ValueError(
                f"out_window has {out_window.shape[0]} per-expert windows "
                f"for E={e} batched tiles")
        if out_window.dim() > 1:
            raise ValueError(f"out_window must be scalar or (E,); got shape "
                             f"{tuple(out_window.shape)}")
    if code_dtype == "auto":
        code_dtype = "int8" if not x_codes.dtype.is_floating_point else "f32"
    x_scale = x_scale.reshape(ex, m).to(torch.float32).contiguous()
    w_scale = w_scale.reshape(e, n).to(torch.float32).contiguous()
    y = _tdvmm_impl(x_codes, w_codes, x_scale, w_scale, gain, out_bits,
                    out_scale, out_window, backend, code_dtype,
                    bool(fused_calibration))
    return y[0] if squeeze else y
