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

Ragged grouped launches (``group_widths``, ``td_grouped_matmul``) run the
same kernels: a fixed window becomes a per-column window over the member
spans (built once per window, widths and device, then reused), and the
data-calibrated readout gives B2 one slot per member.

Code storage (``code_dtype``, ``core.layers`` picks it per site): "int8"
and "int4" cast the codes to int8 and accumulate exactly in int32 — on the
cuda route int4 packs both operands two codes per byte
(``quant.pack_int4``, as the JAX package's Pallas path does) and B1/B2
unpack on chip; "f32" casts both operands to float32 and accumulates in
float32 (exact for integer codes while worst |acc| < 2^24).  On the card
integer f32 codes need ``max_code`` (the largest |code| of either operand,
which ``core.layers`` knows from the bit widths): up to 256 they run on the
bf16 tile, up to 2047 in 3xTF32, wider ones raise.  Codes with programming
noise are not integers: "f32x3" casts them to float32 as "f32" does and
runs them in 3xTF32 on the card.

Tiles: ``plan_kernel`` resolves the backend and looks the launch's CTA
tile up in the per-shape table (``tdvmm.autotune_lookup``), records every
lookup in ``autotune_report()`` and logs each untuned shape once; callers
pass its tile on (``tile=``).  A call without one (the calibration
capture's ``codes_matmul``) takes the same lookup's tile unrecorded.

Gradients: float32 codes (the straight-through views of QAT) go through
``_TDVMMCore``, a ``torch.autograd.Function`` around every mode (raw,
no-readout, fixed window, data-calibrated B2, ragged ``group_widths``,
expert-batched, shared-x), on the card and on the CPU alike.  Its backward
is the JAX package's custom VJP (``_tdvmm_core_bwd``), never autograd of
the forward (whose rounding has no useful derivative): the readout and the
latch gain pass the gradient straight through, ``z = y / (xs·ws)`` is
recovered behind the ``denom == 0`` guard, a shared-x launch sums the x
cotangent over its group, and the window gets none.  Its products are
float32 matmuls (TF32 off on the card), as the JAX package leaves them to
XLA outside its Pallas kernel.  Integer codes carry no gradient and go
straight to the kernels.
"""
from __future__ import annotations

import functools
import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.kernels.tdvmm import tdvmm


def resolve_backend(backend: str) -> str:
    """'auto' | 'pallas' | 'cuda' -> 'cuda'; 'jnp' -> 'jnp'."""
    if backend in ("auto", "pallas", "cuda"):
        return "cuda"
    if backend != "jnp":
        raise ValueError(f"unknown TD-VMM backend {backend!r}")
    return backend


class KernelPlan(NamedTuple):
    """Resolved backend + the CTA tile for one codes matmul."""
    backend: str
    tile: tdvmm.Tile
    code_dtype: str = "f32"
    autotune_hit: bool = False   # False: plan_tile's rule (an untuned shape)
    platform: str = "plain"      # "sm_90a" for codes on the card


# Every plan_kernel lookup of this process by (M, K, N, storage name): the
# report that shows which shapes ran untuned
_AUTOTUNE_LOG: dict[tuple[int, int, int, str], dict] = {}
_AUTOTUNE_WARNED: set[tuple[int, int, int, str]] = set()
_logger = logging.getLogger(__name__)


@functools.lru_cache(maxsize=4096)
def _plan(backend: str, m: int, k: int, n: int, code_dtype: str,
          platform: str) -> tuple[KernelPlan, tuple, dict]:
    name = tdvmm.dtype_name(code_dtype)
    tile, hit = tdvmm.autotune_lookup(m, k, n, name, platform)
    entry = {"tile": tile.name, "hit": hit, "platform": platform}
    return (KernelPlan(resolve_backend(backend), tile, code_dtype, hit,
                       platform), (m, k, n, name), entry)


def plan_kernel(backend: str, m: int, k: int, n: int,
                code_dtype: str = "f32", device=None) -> KernelPlan:
    """``resolve_backend`` + the (M, K, N, storage)-keyed tile table, for
    codes on ``device``.  Records the lookup in ``autotune_report()`` and
    logs each missed shape once: run ``python -m
    repro_torch.launch.autotune_tdvmm`` on the card to tune it."""
    platform = tdvmm.autotune_platform(device)
    kp, key, entry = _plan(backend, int(m), int(k), int(n), code_dtype,
                           platform)
    _AUTOTUNE_LOG[key] = entry
    if not kp.autotune_hit and key not in _AUTOTUNE_WARNED:
        _AUTOTUNE_WARNED.add(key)
        # logged, not warnings.warn: planning runs on hot, otherwise
        # warning-free paths; the miss also lands in autotune_report()
        _logger.warning(
            "TD-VMM autotune miss: no table entry for (M, K, N, dtype)="
            "(%d, %d, %d, %s); using plan_tile's %s tile.  Run python -m "
            "repro_torch.launch.autotune_tdvmm to tune this shape.",
            *key, kp.tile.name)
    return kp


def autotune_report(platform: Optional[str] = None) -> dict:
    """Every (M, K, N, storage) this process planned since the last reset,
    with its tile and whether the table answered.  ``platform`` defaults to
    ``tdvmm.autotune_platform()``."""
    entries = {f"{m}x{k}x{n}:{name}": dict(v)
               for (m, k, n, name), v in sorted(_AUTOTUNE_LOG.items())}
    return {"platform": platform or tdvmm.autotune_platform(),
            "entries": entries,
            "misses": sorted(k for k, v in entries.items() if not v["hit"])}


def reset_autotune_report() -> None:
    _AUTOTUNE_LOG.clear()


def _f32(v, device) -> torch.Tensor:
    """A float32 scalar (or (E,) tuple) as a tensor on ``device``; a scalar
    is filled on the device, a tuple copied once and then reused."""
    if isinstance(v, tuple):
        return _window_values(v, torch.device(device))
    return torch.full((), float(np.float32(v)), dtype=torch.float32,
                      device=device)


@functools.lru_cache(maxsize=256)
def _window_values(values: tuple, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(values, np.float32)).to(device)


def _member_ids(group_widths: tuple, n: int) -> np.ndarray:
    """Column -> owning member over the ragged concat span; pad columns
    past the members get id G."""
    ids = np.full(n, len(group_widths), np.int64)
    ids[:sum(group_widths)] = np.repeat(np.arange(len(group_widths)),
                                        group_widths)
    return ids


@functools.lru_cache(maxsize=256)
def _member_window_cols(values: tuple, group_widths: tuple, n: int,
                        device: torch.device) -> torch.Tensor:
    """(G,) per-member window values -> a (1, 1, N) per-column window over
    the ragged concat span (pad columns get 1.0: they only ever multiply
    zero-code outputs).  Built once per (values, widths, N, device)."""
    vals = np.append(np.asarray(values, np.float32), np.float32(1.0))
    cols = vals[_member_ids(group_widths, n)]
    return torch.from_numpy(cols).to(device).reshape(1, 1, n)


@functools.lru_cache(maxsize=256)
def _member_col_index(group_widths: tuple, n: int,
                      device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_member_ids(group_widths, n)).to(device)


def _member_window_cols_arr(values: torch.Tensor, group_widths: tuple,
                            n: int) -> torch.Tensor:
    """Tensor sibling of ``_member_window_cols``: a (G,) window tensor
    gathered out to the (1, 1, N) per-column window (pad columns 1.0) with
    a cached device index, so a swapped window copies nothing from the
    host."""
    dev = values.device
    vals = torch.cat([values.reshape(-1).to(torch.float32),
                      torch.ones(1, dtype=torch.float32, device=dev)])
    return vals[_member_col_index(tuple(group_widths), n, dev)].reshape(1, 1, n)


# ---------------------------------------------------------------------------
# Epilogue (unfused form; the kernels mirror this term for term)
# ---------------------------------------------------------------------------
def _epilogue(acc, x_scale, w_scale, gain, out_bits, out_scale,
              out_window=None, group_widths=None):
    """gain -> optional p-bit readout -> per-row x per-channel rescale.

    acc: (E, M, N) int32, non-empty; x_scale: (E|1, M); w_scale: (E, N).
    ``out_scale=None`` calibrates the ADC window to max|z| *per expert tile*;
    a tuple is an (E,)-vector of fixed per-expert windows; ``out_window`` is
    the tensor form of a fixed window (scalar or (E,)) — the serving engine's
    runtime operand.  With ``group_widths`` (a ragged concat launch) windows
    are per member column span instead: a tuple or an ``out_window`` holds
    one window per member, and data calibration takes max|z| over each
    member's columns."""
    s = None
    if out_bits is not None:
        dev = acc.device
        n = acc.shape[-1]
        if out_window is not None:
            ow = out_window.to(device=dev, dtype=torch.float32)
            if group_widths is not None:
                s = _member_window_cols_arr(ow, group_widths, n)
            else:
                s = ow.reshape(-1, 1, 1) if ow.dim() >= 1 else ow
        elif out_scale is None:
            z = torch.abs(acc.to(torch.float32) * _f32(gain, dev))
            if group_widths is not None:
                off, segs = 0, []
                for wd in group_widths:
                    seg = torch.amax(z[..., off:off + wd], dim=(-2, -1),
                                     keepdim=True)
                    segs.append(seg.expand(seg.shape[:-1] + (wd,)))
                    off += wd
                s = torch.cat(segs, dim=-1)
            else:
                s = torch.amax(z, dim=(-2, -1), keepdim=True)
            s = torch.maximum(s, _f32(1e-9, dev))
        elif isinstance(out_scale, tuple):
            if group_widths is not None:
                s = _member_window_cols(out_scale, tuple(group_widths), n,
                                        torch.device(dev))
            else:
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
        # built on the host (numpy), as a constant: no device op
        ids = np.repeat(np.arange(e, dtype=np.int32)[:, None], nn, axis=1)
        return torch.from_numpy(ids), e
    bounds = np.cumsum(group_widths)
    ids = np.searchsorted(bounds, np.arange(nn) * bn, side="right")
    ids = np.minimum(ids, len(group_widths) - 1).astype(np.int32)
    return torch.from_numpy(ids[None, :]), len(group_widths)


@functools.lru_cache(maxsize=64)
def _device_calib_slots(e: int, n: int, bn: int, group_widths,
                        device: torch.device) -> tuple[torch.Tensor, int]:
    slots, nslots = _calib_slots(e, n, bn, group_widths)
    return slots.to(device), nslots


def _operands(x_codes, w_codes, code_dtype: str):
    """(x, w, int4_k) as the kernels take them: int8 codes for "int8";
    int4 pairs packed along K for "int4" (``int4_k`` the code depth);
    float32 for "f32" and "f32x3"."""
    if code_dtype not in ("int8", "int4", "f32", "f32x3"):
        raise ValueError(f"unknown code dtype {code_dtype!r}")
    dtype = torch.float32 if code_dtype.startswith("f32") else torch.int8
    xi = x_codes.to(dtype).contiguous()
    wi = w_codes.to(dtype).contiguous()
    if code_dtype != "int4":
        return xi, wi, None
    return (quant.pack_int4(xi, axis=-1).contiguous(),
            quant.pack_int4(wi, axis=-2).contiguous(), xi.shape[-1])


def _tdvmm_impl(x_codes, w_codes, x_scale, w_scale, gain, out_bits,
                out_scale, out_window, backend, code_dtype,
                fused_calibration, group_widths=None, max_code=None,
                tile=None):
    ex, m, k = x_codes.shape
    e, _, n = w_codes.shape
    if min(e, m, k, n) == 0:
        # zero charge everywhere, and readout(0) * scales == 0 on every path
        return torch.zeros((e, m, n), dtype=torch.float32,
                           device=x_codes.device)
    if backend == "jnp":
        # int4 codes accumulate unpacked, as int8 (the JAX package's jnp path)
        xi, wi, _ = _operands(x_codes, w_codes,
                              "int8" if code_dtype == "int4" else code_dtype)
        return _epilogue(tdvmm.acc_plain(xi, wi), x_scale, w_scale, gain,
                         out_bits, out_scale, out_window, group_widths)
    xi, wi, int4_k = _operands(x_codes, w_codes, code_dtype)
    if out_bits is None or out_scale is not None or out_window is not None:
        window = None
        if out_bits is not None:
            if out_window is not None:
                window = out_window.to(device=xi.device, dtype=torch.float32)
                if group_widths is not None:
                    window = _member_window_cols_arr(window, group_widths, n)
            elif group_widths is not None and isinstance(out_scale, tuple):
                window = _member_window_cols(out_scale, group_widths, n,
                                             xi.device)
            else:
                window = _f32(out_scale, xi.device)
        return tdvmm.tdvmm_fused(xi, wi, x_scale, w_scale, gain, out_bits,
                                 window, int4_k, max_code, code_dtype, tile)
    if fused_calibration:
        # every member span is a multiple of the 128 lane, so no 64-column
        # tile of B2 straddles two members' readout slots
        slots, nslots = _device_calib_slots(e, n, tdvmm.TILE_N, group_widths,
                                            xi.device)
        return tdvmm.tdvmm_calibrated(
            xi, wi, x_scale, w_scale, slots, nslots,
            min(tdvmm.TILE_N, n), gain, out_bits, int4_k, max_code,
            code_dtype, tile)
    acc = tdvmm.tdvmm_matmul_raw(xi, wi, int4_k, max_code, code_dtype, tile)
    return _epilogue(acc, x_scale, w_scale, gain, out_bits, out_scale,
                     out_window, group_widths)


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A float32 product of the backward: full float32 on the card (TF32
    off, PyTorch's default, which the port never changes)."""
    if a.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TD-VMM gradients are float32 products: turn "
                           "torch.backends.cuda.matmul.allow_tf32 off")
    return torch.matmul(a, b)


def _code_grads(dacc: torch.Tensor, xf: torch.Tensor, wf: torch.Tensor,
                need_x: bool, need_w: bool):
    """(gx, gw) of acc = x @ w for the accumulator's cotangent ``dacc``
    (E, M, N); x (E|1, M, K), w (E, K, N).  A shared-x launch (one x batch
    entry against G tiles) sums the x cotangent over the group axis."""
    gx = gw = None
    if xf.shape[0] == 1 and dacc.shape[0] > 1:
        g_, m, n = dacc.shape
        if need_x:
            gx = _matmul_f32(dacc.permute(1, 0, 2).reshape(m, g_ * n),
                             wf.permute(0, 2, 1).reshape(g_ * n, -1))[None]
        if need_w:
            gw = _matmul_f32(xf[0].transpose(0, 1), dacc)
    else:
        if need_x:
            gx = _matmul_f32(dacc, wf.transpose(-1, -2))
        if need_w:
            gw = _matmul_f32(xf.transpose(-1, -2), dacc)
    return gx, gw


class _TDVMMCore(torch.autograd.Function):
    """Differentiable integrate + epilogue on (E|1, M, K) x (E, K, N) float32
    codes: the forward is ``_tdvmm_impl`` (the kernels on the card), the
    backward the JAX package's ``_tdvmm_core_bwd`` formula."""

    @staticmethod
    def forward(ctx, x_codes, w_codes, x_scale, w_scale, out_window, static):
        (gain, out_bits, out_scale, backend, code_dtype, fused_calibration,
         group_widths, max_code, tile) = static
        y = _tdvmm_impl(x_codes, w_codes, x_scale, w_scale, gain, out_bits,
                        out_scale, out_window, backend, code_dtype,
                        fused_calibration, group_widths, max_code, tile)
        ctx.save_for_backward(x_codes, w_codes, x_scale, w_scale, y)
        ctx.gain = gain
        return y

    @staticmethod
    def backward(ctx, g):
        x_codes, w_codes, x_scale, w_scale, y = ctx.saved_tensors
        need = ctx.needs_input_grad
        denom = x_scale[..., :, None] * w_scale[..., None, :]
        # identity through the readout quantizer (STE) and the latch gain
        dacc = g * denom * float(np.float32(ctx.gain))
        gx, gw = _code_grads(dacc, x_codes.to(torch.float32),
                             w_codes.to(torch.float32), need[0], need[1])
        gxs = gws = None
        if need[2] or need[3]:
            # the post-readout latch value; callers clamp scales >= 1e-6,
            # so the guard only covers direct calls with zero scales
            z = torch.where(denom == 0.0, 0.0, y / denom)
            if need[2]:
                gxs = torch.sum(g * z * w_scale[..., None, :], dim=-1)
                if x_codes.shape[0] == 1 and g.shape[0] > 1:
                    gxs = torch.sum(gxs, dim=0, keepdim=True)
            if need[3]:
                gws = torch.sum(g * z * x_scale[..., :, None], dim=-2)
        # the window is calibration state, not a trainable: no cotangent
        return gx, gw, gxs, gws, None, None


class _CodesMatmul(torch.autograd.Function):
    """Raw float32 codes product (B1 raw mode on the card) with the plain
    matmul cotangents."""

    @staticmethod
    def forward(ctx, x3, w3, backend, code_dtype, max_code):
        ctx.save_for_backward(x3, w3)
        return _raw_acc(x3, w3, backend, code_dtype, max_code)

    @staticmethod
    def backward(ctx, g):
        x3, w3 = ctx.saved_tensors
        gx, gw = _code_grads(g, x3, w3, ctx.needs_input_grad[0],
                             ctx.needs_input_grad[1])
        return gx, gw, None, None, None


def _raw_acc(x3, w3, backend, code_dtype, max_code) -> torch.Tensor:
    return raw_acc(x3, w3, backend, code_dtype, max_code).to(torch.float32)


def raw_acc(x3, w3, backend, code_dtype, max_code,
            tile: Optional[tdvmm.Tile] = None) -> torch.Tensor:
    """The raw (E|1, M, K) x (E, K, N) charge accumulation in the storage's
    own dtype: int32 for integer codes (exact), float32 for float32 codes
    (B1 raw mode on the card, at ``tile`` or the lookup's).  A
    tensor-parallel row site sums these over ``model`` before its one
    epilogue."""
    if backend == "jnp":
        xi, wi, _ = _operands(x3, w3,
                              "int8" if code_dtype == "int4" else code_dtype)
        return tdvmm.acc_plain(xi, wi)
    return tdvmm.tdvmm_matmul_raw(*_operands(x3, w3, code_dtype),
                                  max_code=max_code, code_dtype=code_dtype,
                                  tile=tile)


def epilogue(acc, x_scale, w_scale, gain, out_bits, out_scale=None,
             out_window=None, group_widths=None):
    """``tdvmm_matmul``'s epilogue on a finished (E, M, N) accumulator
    (``raw_acc``'s), with its scale layouts: the same bits as the fused
    and calibrated launches on the same accumulator."""
    e, m, n = acc.shape
    x_scale = x_scale.reshape(-1, m).to(torch.float32).contiguous()
    w_scale = w_scale.reshape(e, n).to(torch.float32).contiguous()
    if min(e, m, n) == 0:
        return torch.zeros((e, m, n), dtype=torch.float32, device=acc.device)
    return _epilogue(acc, x_scale, w_scale, gain, out_bits, out_scale,
                     out_window, None if group_widths is None
                     else tuple(int(w) for w in group_widths))


def codes_matmul(x_codes: torch.Tensor, w_codes: torch.Tensor,
                 backend: str, code_dtype: str = "auto",
                 max_code: Optional[int] = None) -> torch.Tensor:
    """Raw (.., M, K) @ (.., K, N) charge accumulation as f32 (B1 raw mode
    on the cuda route).  A 2-D x against a 3-D (G, K, N) bank runs shared-x:
    one code matrix against G tiles, returning (G, M, N) (no squeeze).
    ``max_code``: the largest |code| of either operand (integer f32 codes on
    the card need it).  Float32 codes are differentiable (plain matmul
    cotangents)."""
    squeeze = x_codes.dim() == 2 and w_codes.dim() == 2
    x3 = x_codes[None] if x_codes.dim() == 2 else x_codes
    w3 = w_codes[None] if w_codes.dim() == 2 else w_codes
    if code_dtype == "auto":
        code_dtype = "int8" if not x3.dtype.is_floating_point else "f32"
    backend = resolve_backend(backend)
    if x3.dtype.is_floating_point:
        acc = _CodesMatmul.apply(x3, w3, backend, code_dtype, max_code)
    else:
        acc = _raw_acc(x3, w3, backend, code_dtype, max_code)
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
    max_code: Optional[int] = None,
    tile: Optional[tdvmm.Tile] = None,
) -> torch.Tensor:
    """Quantized four-quadrant TD-VMM: codes matmul + readout + scale epilogue.

    ``out_scale=None`` calibrates the readout window from the data (§3.1);
    a float or an (E,)-tuple pins it.  ``out_window`` is the tensor form of
    a fixed window — scalar, per-expert (E,) or per-member (G,) — bitwise
    interchangeable with ``out_scale``.  Shared-x: a 2-D (M, K) x against a
    3-D (G, K, N) bank returns (G, M, N) un-squeezed.

    Ragged grouped: ``group_widths=(N_1, ..., N_G)`` declares a 2-D
    (M, K) x (K, sum N_g) launch as the column concat of G same-input
    members; readout windows (tuple ``out_scale``, ``out_window`` or data
    calibration) resolve per member column span instead of per launch.

    ``max_code`` is the largest |code| of either operand; integer float32
    codes ("f32") on the card need it (``tdvmm.check_code_width`` picks
    their storage from it).  ``code_dtype="f32x3"`` marks float32 codes
    off the integer grid.  ``tile``: the CTA tile of the caller's
    ``plan_kernel`` (the JAX package's ``block_sizes``), else the lookup's.

    Float32 codes (straight-through views) are differentiable through
    ``_TDVMMCore``; integer codes are not.
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
        group_widths = tuple(int(w) for w in group_widths)
        if ex != 1 or e != 1:
            raise ValueError(
                "group_widths describes a 2-D ragged concat launch; got "
                f"batched codes (x batch {ex}, w batch {e})")
        if sum(group_widths) != n:
            raise ValueError(
                f"group_widths {group_widths} sum to {sum(group_widths)} "
                f"but the concat weight bank has N={n}")
        if isinstance(out_scale, tuple) and \
                len(out_scale) != len(group_widths):
            raise ValueError(
                f"out_scale has {len(out_scale)} member windows for "
                f"{len(group_widths)} group members")
    elif isinstance(out_scale, tuple) and len(out_scale) != e:
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
        if group_widths is not None:
            if tuple(out_window.shape) != (len(group_widths),):
                raise ValueError(
                    f"out_window shape {tuple(out_window.shape)} for a "
                    f"{len(group_widths)}-member grouped launch; expected "
                    f"({len(group_widths)},)")
        elif out_window.dim() == 1 and out_window.shape[0] != e:
            raise ValueError(
                f"out_window has {out_window.shape[0]} per-expert windows "
                f"for E={e} batched tiles")
        elif out_window.dim() > 1:
            raise ValueError(f"out_window must be scalar, (E,) or (G,); got "
                             f"shape {tuple(out_window.shape)}")
    if code_dtype == "auto":
        code_dtype = "int8" if not x_codes.dtype.is_floating_point else "f32"
    x_scale = x_scale.reshape(ex, m).to(torch.float32).contiguous()
    w_scale = w_scale.reshape(e, n).to(torch.float32).contiguous()
    if x_codes.dtype.is_floating_point:
        y = _TDVMMCore.apply(
            x_codes, w_codes, x_scale, w_scale, out_window,
            (gain, out_bits, out_scale, backend, code_dtype,
             bool(fused_calibration), group_widths, max_code, tile))
    else:
        y = _tdvmm_impl(x_codes, w_codes, x_scale, w_scale, gain, out_bits,
                        out_scale, out_window, backend, code_dtype,
                        bool(fused_calibration), group_widths, max_code,
                        tile)
    return y[0] if squeeze else y
