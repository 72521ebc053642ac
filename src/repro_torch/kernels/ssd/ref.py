"""Token-by-token oracle for the SSD scan (torch port of
``repro.kernels.ssd.ref.ssd_naive``): the recurrence by definition, exact
and slow; tests only."""
from __future__ import annotations

import torch


def ssd_naive(x, dt, a_log, b, c):
    """x: (B, L, H, P); dt: (B, L, H); a_log: (H,); b, c: (B, L, G, S).
    Returns (y (B, L, H, P) in x's dtype, final_state (B, H, P, S))."""
    B, L, H, Pd = x.shape
    G, S = b.shape[2], b.shape[3]
    rep = H // G
    f32 = torch.float32
    a = -torch.exp(a_log.to(f32))
    bh = b.repeat_interleave(rep, dim=2).to(f32)
    ch = c.repeat_interleave(rep, dim=2).to(f32)
    dtf = dt.to(f32)
    state = torch.zeros((B, H, Pd, S), dtype=f32, device=x.device)
    ys = []
    for t in range(L):
        decay = torch.exp(dtf[:, t] * a)[..., None, None]
        upd = torch.einsum("bhs,bh,bhp->bhps", bh[:, t], dtf[:, t],
                           x[:, t].to(f32))
        state = state * decay + upd
        ys.append(torch.einsum("bhs,bhps->bhp", ch[:, t], state))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(x, dtype=f32)
    return y.to(x.dtype), state
