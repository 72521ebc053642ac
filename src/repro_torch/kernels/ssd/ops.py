"""The SSD entry point that returns y alone (the JAX package's
``kernels/ssd/ops.ssd``): kernel B3 for tensors on the card, its plain
version for tensors on the CPU, through ``ssd.ssd_scan``, with no
fallback."""
from __future__ import annotations

from repro_torch.kernels.ssd import ssd as _ssd


def ssd(x, dt, a_log, b, c, chunk: int = 128):
    """Mamba-2 SSD scan: returns y (B, L, H, P) in x's dtype, from a zero
    initial state (layouts as ``ssd.ssd_scan``'s)."""
    return _ssd.ssd_scan(x, dt, a_log, b, c, chunk)[0]
