"""Plain torch oracle for the TD-VMM quantized matmul (mirrors
``repro.kernels.tdvmm.ref``).

    z[m, n] = (sum_k xc[m, k] * wc[k, n]) * gain          charge + latch
    z       = readout(z, out_bits)                        p-bit ADC (§4.2)
    y[m, n] = z[m, n] * x_scale[m] * w_scale[n]           digital rescale

Integer codes accumulate exactly (int64 on the CPU, float64 on the card);
a data-calibrated window (out_scale=None) is taken per expert tile.  The
readout is written independently of ``ops``/``tdvmm`` (``z / s`` and
``/ levels * s``), so it agrees with them to float tolerance, not bitwise.
"""
from __future__ import annotations

import torch


def tdvmm_matmul_ref(
    x_codes: torch.Tensor,      # (M, K) or (E, M, K) integer codes
    w_codes: torch.Tensor,      # (K, N) or (E, K, N)
    x_scale: torch.Tensor,      # (M,), (M, 1) or (E, M)
    w_scale: torch.Tensor,      # (N,) or (E, N)
    gain: float,
    out_bits: int | None = None,
    out_scale: float | None = None,
) -> torch.Tensor:
    acc_t = torch.int64 if x_codes.device.type == "cpu" else torch.float64
    acc = torch.matmul(x_codes.to(acc_t), w_codes.to(acc_t))
    z = acc.to(torch.float32) * gain
    if out_bits is not None:
        levels = (1 << out_bits) - 1
        s = out_scale if out_scale is not None else torch.clamp_min(
            torch.amax(torch.abs(z), dim=(-2, -1), keepdim=True), 1e-9)
        z = torch.round(torch.clamp(z / s, -1.0, 1.0) * levels) / levels * s
    xs = x_scale.reshape(z.shape[:-2] + (z.shape[-2], 1))
    ws = w_scale.reshape(z.shape[:-2] + (1, z.shape[-1]))
    return (z * xs) * ws
