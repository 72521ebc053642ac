"""Kernel B3, the Mamba-2 SSD chunked scan, for Hopper; its plain torch
version; a launch counter.

B3 (``csrc/ssd.cu``) replaces the Pallas ``ssd._kernel``
(``repro/kernels/ssd/ssd.py``) with Mamba-2's chunked decomposition on the
tensor cores: C.B^T once per (row, group, chunk) and the prefix sums of
dt * a; the state carried over the chunks; then y, every chunk in parallel
(three device kernels, one ``ssd_scan`` call; 3xTF32 products, see the
source).  ``ssd_plain`` is the same function in torch ops: the JAX
package's ``models/ssm.ssd_chunked``, term for term (its decay mask goes
in before the exp, the same values with a finite gradient), and the
training path's scan under autograd.

Layouts are the JAX package's: x (B, L, H, P), dt (B, L, H) float32,
a_log (H,) float32, b and c (B, L, G, S) with G dividing H; the result is
y (B, L, H, P) in x's dtype and the final state (B, H, P, S) float32, from
a zero initial state.  L is padded to a multiple of the chunk with dt = 0,
which neither decays nor updates the state.

``ssd_scan`` follows the port's one rule: a CPU tensor goes to the plain
version, a tensor on the card to the kernel or an exception.  The kernel
sums in another order than the plain version, so the two agree within a
float tolerance, not bitwise.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, hooks

CSRC = Path(__file__).parent / "csrc"

LAUNCHES = {"ssd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_b3.argtypes = [vp] * 11 + [i] * 10 + [vp]
    lib.ssd_b3.restype = i


# no --use_fast_math: expf, not __expf
LIBRARIES = {"b3": _build.Library("ssd_b3", CSRC / "ssd.cu", (), _bind)}
# what B3 takes on the card (``ssd::kMaxQ``, ``ssd::kMaxS`` in csrc/ssd.cu)
MAX_CHUNK, MAX_STATE = 128, 128


def _pad_len(x, dt, b, c, chunk: int):
    """(x, dt, b, c, Q) with L padded to a multiple of Q = min(chunk, L)."""
    L = x.shape[1]
    q = min(chunk, L)
    pad = (-L) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    return x, dt, b, c, q


def _check(x, dt, a_log, b, c) -> None:
    if x.dim() != 4 or dt.dim() != 3 or a_log.dim() != 1 or b.dim() != 4 \
            or c.shape != b.shape:
        raise ValueError(
            f"ssd: x (B, L, H, P), dt (B, L, H), a_log (H,), b/c (B, L, G, S)"
            f"; got {tuple(x.shape)}, {tuple(dt.shape)}, "
            f"{tuple(a_log.shape)}, {tuple(b.shape)}, {tuple(c.shape)}")
    bsz, L, H, _ = x.shape
    if tuple(dt.shape) != (bsz, L, H) or a_log.shape[0] != H \
            or b.shape[:2] != (bsz, L) or H % b.shape[2]:
        raise ValueError(f"ssd: inconsistent shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a_log {tuple(a_log.shape)}, "
                         f"b {tuple(b.shape)}")
    devs = {t.device for t in (x, dt, a_log, b, c)}
    if len(devs) != 1:
        raise ValueError(f"ssd: operands on {sorted(map(str, devs))}")


# ---------------------------------------------------------------------------
# Plain version (the JAX package's ssd_chunked, in torch ops)
# ---------------------------------------------------------------------------
def ssd_plain(x, dt, a_log, b, c, chunk: int = 128):
    """Chunked SSD scan in torch ops.  Returns (y (B, L, H, P) in x's dtype,
    final_state (B, H, P, S) float32)."""
    _check(x, dt, a_log, b, c)
    bsz, L, H, Pd = x.shape
    G, S = b.shape[2], b.shape[3]
    f32 = torch.float32
    if L == 0:
        return x.clone(), torch.zeros((bsz, H, Pd, S), dtype=f32,
                                      device=x.device)
    x, dt, b, c, Q = _pad_len(x, dt, b, c, chunk)
    L_pad = x.shape[1]
    nc = L_pad // Q
    rep = H // G

    a = -torch.exp(a_log.to(f32))                          # (H,)
    dta = dt.to(f32) * a                                   # (B, L, H)
    x_ = x.reshape(bsz, nc, Q, H, Pd)
    dt_ = dt.reshape(bsz, nc, Q, H).to(f32)
    dta_ = dta.reshape(bsz, nc, Q, H)
    bh = b.reshape(bsz, nc, Q, G, S).repeat_interleave(rep, dim=3)
    ch = c.reshape(bsz, nc, Q, G, S).repeat_interleave(rep, dim=3)

    cum = torch.cumsum(dta_, dim=2)                        # (B,nc,Q,H)
    total = cum[:, :, -1]                                  # (B,nc,H)

    # intra-chunk: M[i, j] = exp(cum_i - cum_j) for j <= i.  The mask goes
    # in before the exp (exp(-inf) = 0): the same values as masking after
    # it, but no exp overflows above the diagonal, where its gradient
    # would be 0 * inf = NaN under autograd (training)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Q,Q,H)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    m = torch.exp(torch.where(causal[None, None, :, :, None], diff,
                              torch.full((), -math.inf, dtype=f32,
                                         device=x.device)))
    g = torch.einsum("bnihs,bnjhs->bnijh", ch.to(f32), bh.to(f32))
    w = g * m * dt_[:, :, None, :, :]
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", w, x_.to(f32))

    # per-chunk end state
    decay_to_end = torch.exp(total[:, :, None, :] - cum)   # (B,nc,Q,H)
    sc = torch.einsum("bnqhs,bnqh,bnqhp->bnhps", bh.to(f32),
                      decay_to_end * dt_, x_.to(f32))

    # inter-chunk recurrence over nc
    state = torch.zeros((bsz, H, Pd, S), dtype=f32, device=x.device)
    prev = []
    for n in range(nc):
        prev.append(state)
        state = state * torch.exp(total[:, n])[:, :, None, None] + sc[:, n]
    prev_states = torch.stack(prev, dim=1)                 # (B,nc,H,P,S)

    y_inter = torch.einsum("bnqhs,bnhps,bnqh->bnqhp", ch.to(f32), prev_states,
                           torch.exp(cum))
    y = (y_intra + y_inter).reshape(bsz, L_pad, H, Pd)[:, :L]
    return y.to(x.dtype), state


# ---------------------------------------------------------------------------
# Wrapper (kernel on the card, plain version on the CPU)
# ---------------------------------------------------------------------------
def staging(x, b, c) -> tuple[int, int]:
    """(vec_x, vec_bc): whether B3 may copy x's rows, and b's and c's rows,
    as 16-byte ``cp.async`` copies (rows of a multiple of 16 bytes on a
    16-byte aligned base); where not, it copies them element by element."""
    elt = x.element_size()
    vec_x = int(x.data_ptr() % 16 == 0 and x.shape[-1] * elt % 16 == 0)
    vec_bc = int(b.data_ptr() % 16 == 0 and c.data_ptr() % 16 == 0
                 and b.shape[-1] * elt % 16 == 0)
    return vec_x, vec_bc


def ssd_scan(x, dt, a_log, b, c, chunk: int = 128):
    """B3: the chunked SSD scan.  Returns (y (B, L, H, P) in x's dtype,
    final_state (B, H, P, S) float32).

    x, b and c are float32 or bfloat16 (one dtype); dt and a_log float32."""
    if hooks.HOOK is None:
        return _scan(x, dt, a_log, b, c, chunk)
    bsz, L, H, Pd = x.shape
    with hooks.call("ssd", b=bsz, l=L, h=H, p=Pd, g=b.shape[2],
                    s=b.shape[3], q=chunk, elt=x.element_size()):
        return _scan(x, dt, a_log, b, c, chunk)


def _scan(x, dt, a_log, b, c, chunk: int = 128):
    if x.device.type == "cpu" and not hooks.is_fake(x):
        return ssd_plain(x, dt, a_log, b, c, chunk)
    if not hooks.card_route(x):
        raise ValueError(f"ssd_scan runs on cuda (or plain on cpu), got "
                         f"{x.device}")
    _check(x, dt, a_log, b, c)
    if x.dtype not in (torch.float32, torch.bfloat16) or b.dtype != x.dtype \
            or c.dtype != x.dtype:
        raise NotImplementedError(
            f"B3 takes float32 or bfloat16 x/b/c of one dtype, got {x.dtype}, "
            f"{b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a_log.dtype != torch.float32:
        raise ValueError(f"B3 takes float32 dt and a_log, got {dt.dtype}, "
                         f"{a_log.dtype}")
    bsz, L, H, Pd = x.shape
    G, S = b.shape[2], b.shape[3]
    state = torch.empty((bsz, H, Pd, S), dtype=torch.float32, device=x.device)
    if L == 0:
        return torch.empty_like(x), state.zero_()
    xp, dtp, bp, cp, q = _pad_len(x, dt, b, c, chunk)
    if q > MAX_CHUNK or S > MAX_STATE:
        raise NotImplementedError(
            f"B3 takes a chunk of at most {MAX_CHUNK} and d_state of at most "
            f"{MAX_STATE}, got Q={q}, S={S}")
    xp, dtp, bp, cp = (t.contiguous() for t in (xp, dtp, bp, cp))
    a_log = a_log.contiguous()
    L_pad = xp.shape[1]
    nc, qp = L_pad // q, -(-q // 16) * 16
    y = torch.empty((bsz, L_pad, H, Pd), dtype=x.dtype, device=x.device)
    # scratch: C.B^T per (row, group, chunk); prefix sums and dt per (row,
    # chunk, head); the state carried into each chunk
    f32 = dict(dtype=torch.float32, device=x.device)
    gmat = torch.empty(bsz * G * nc * qp * qp, **f32)
    cum = torch.empty(bsz * nc * H * qp, **f32)
    dtc = torch.empty_like(cum)
    states = torch.empty(bsz * nc * H * Pd * S, **f32)
    if hooks.is_fake(x):
        return (y if L_pad == L else y[:, :L]), state
    vec_x, vec_bc = staging(xp, bp, cp)
    err = _build.load(LIBRARIES["b3"]).ssd_b3(
        xp.data_ptr(), dtp.data_ptr(), a_log.data_ptr(), bp.data_ptr(),
        cp.data_ptr(), y.data_ptr(), state.data_ptr(), gmat.data_ptr(),
        cum.data_ptr(), dtc.data_ptr(), states.data_ptr(), bsz, L_pad, H, Pd,
        G, S, q, 0 if x.dtype == torch.float32 else 1, vec_x, vec_bc,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check_launch(err, f"ssd_scan (B={bsz}, L={L_pad}, H={H}, P={Pd}, "
                             f"G={G}, S={S}, Q={q})")
    LAUNCHES["ssd"] += 1
    return (y if L_pad == L else y[:, :L]), state
