"""td_matmul: the paper's multiplier as a drop-in linear layer (torch port
of ``repro.core.layers``).

td_matmul is the closed form of the four-quadrant TD-VMM, structured as the
code-and-scale pipeline of ``core/quant.py``:

    plan         flatten (..., N_in) to 2-D, pick code storage, resolve the
                 integrate backend and the kernels' CTA tile from the
                 per-shape table (``ops.plan_kernel``)
    encode       x -> p-bit signed time codes + per-row scale   (Eq. 2, DAC)
    program      W -> signed current codes + per-channel scale  (FG tuning)
    integrate    codes matmul — kernel B1/B2 on the card, the plain torch
                 version on the CPU; identical integer arithmetic
    readout      latch normalization + p-bit ADC over the calibrated output
                 window when the tile boundary is digital      (Eq. 3, §4.2)
    rescale      digital per-row x per-channel rescale to model units

``td_expert_matmul`` is the batched (E, C, K) x (E, K, N) form for MoE
expert banks: one analog tile per expert, per-expert scales and (E,)
readout windows, the expert dim on the kernels' batched grid axis.
``td_grouped_matmul`` runs G same-input projections (``ssm.in_proj``) as
one ragged concat launch.  ``TDVMMLinear`` is the JAX package's layer
object as an ``nn.Module`` around ``td_matmul`` (``init_linear`` draws its
weight).

Code storage follows the JAX package's rule (``_plan_code_dtype``): int8
for p <= 7 on both operands, int4-packed pairs for p <= 3 on both, float32
codes for p = 8 ("f32") or with programming noise ("f32x3": float32 codes
off the integer grid, B1/B2's 3xTF32 storage on the card), warning where
the worst |acc| reaches 2^24, beyond which the float32 sums may round.

Gradients (QAT): straight-through estimators on every quantizer
(``quant.QuantizedTensor.view``) and the JAX package's custom VJP on the
integrate stage (``kernels/tdvmm/ops._TDVMMCore``): when x or w needs a
gradient the layer hands the kernels the float32 straight-through views,
else the stored codes.  Programming noise (``cfg.noise`` with a ``key``:
an int seed or ``quant.NoiseDraws``) perturbs the programmed currents
(``quant.program_noise``): the codes are then float32 off the integer grid
and take the "f32x3" storage.
"""
from __future__ import annotations

import math
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import TDVMMLayerConfig  # re-export
from repro_torch.core import quant

__all__ = ["TDVMMLayerConfig", "TDVMMLinear", "td_matmul",
           "td_expert_matmul", "td_grouped_matmul", "calibrate_out_scale",
           "init_linear"]

class MatmulPlan(NamedTuple):
    """Shape/backend/storage bookkeeping for one td_matmul call."""
    batch_shape: tuple[int, ...]     # leading dims of x, flattened into M
    m: int
    k: int                           # N_in: sources per output column
    n: int
    backend: str                     # resolved: "jnp" | "cuda"
    code_dtype: str                  # "int4" | "int8" | "f32" | "f32x3"
    tile: "tdvmm.Tile"               # the kernels' CTA tile (the table's)


def _plan_code_dtype(cfg: TDVMMLayerConfig, k: int, noisy: bool) -> str:
    """Pick the code storage for a K-deep accumulation (the JAX package's
    rule, kept so both packages agree on every site), warning only on the
    f32 fallback.  Noisy codes, float32 as in the JAX package, are "f32x3":
    they are off the integer grid."""
    lx = (1 << cfg.bits) - 1
    lw = (1 << cfg.weight_bits) - 1
    worst = lx * lw * max(k, 1)
    fits_int8 = (quant.storage_dtype(cfg.bits) == torch.int8
                 and quant.storage_dtype(cfg.weight_bits) == torch.int8)
    if not noisy and fits_int8 and worst < (1 << 31):
        if cfg.bits <= quant.INT4_MAX_BITS and \
                cfg.weight_bits <= quant.INT4_MAX_BITS:
            return "int4"
        return "int8"
    if worst >= (1 << 24):
        warnings.warn(
            f"TD-VMM f32 accumulator may exceed f32 integer range: "
            f"(2^{cfg.bits}-1)*(2^{cfg.weight_bits}-1)*K={worst} >= 2^24; "
            "charge sums can round and the kernel and plain routes may "
            "diverge", stacklevel=3)
    return "f32x3" if noisy else "f32"


def plan_matmul(x_shape, w_shape, cfg: TDVMMLayerConfig,
                noisy: bool = False, device=None,
                k_global: Optional[int] = None) -> MatmulPlan:
    """The plan of an (..., K) x (K, N) launch of codes on ``device``; the
    storage is picked for the global K ``k_global`` of a row-parallel
    shard (default K)."""
    k, n = w_shape
    if x_shape[-1] != k:
        raise ValueError(f"td_matmul shapes {tuple(x_shape)} x {tuple(w_shape)}")
    batch_shape = tuple(x_shape[:-1])
    m = 1
    for d in batch_shape:
        m *= d
    code_dtype = _plan_code_dtype(cfg, k if k_global is None else k_global,
                                  noisy)
    from repro_torch.kernels.tdvmm import ops
    kp = ops.plan_kernel(cfg.backend, m, k, n, code_dtype, device)
    return MatmulPlan(batch_shape, m, k, n, kp.backend, code_dtype, kp.tile)


def _readout_args(
    cfg: TDVMMLayerConfig, n_experts: Optional[int] = None
) -> tuple[Optional[int], Optional[float | tuple[float, ...]]]:
    """(out_bits, out_scale) for the kernel epilogue.  Priority: a cached
    calibration window (cfg.out_scale) > data calibration (None, §3.1) > the
    fixed 0.5 raw differential window of a normalized tile."""
    if not cfg.io_quantize:
        return None, None
    if cfg.out_scale is not None:
        s = cfg.out_scale
        if isinstance(s, tuple):
            if n_experts is None:
                if len(s) != 1:
                    raise ValueError(
                        f"site {cfg.site or '<unnamed>'}: per-expert "
                        f"out_scale tuple (len {len(s)}) on a non-batched "
                        "matmul; expected a scalar window")
                return cfg.bits, float(s[0])
            if len(s) != n_experts:
                raise ValueError(
                    f"site {cfg.site or '<unnamed>'}: out_scale has "
                    f"{len(s)} windows for {n_experts} experts")
            return cfg.bits, tuple(float(v) for v in s)
        return cfg.bits, float(s)
    return cfg.bits, (None if cfg.output_calibration else 0.5)


def _runtime_override(cfg: TDVMMLayerConfig, out_bits, out_scale):
    """Swap a site's static readout window for the window tensor installed
    by ``calibration.runtime_windows`` (the serving engine's channel).
    Outside that context — or for sites without a digital readout — this
    is a passthrough."""
    if out_bits is None:
        return out_scale, None
    from repro_torch.core import calibration
    rw = calibration.runtime_window(cfg.site)
    if rw is None:
        return out_scale, None
    return None, rw


def _latch_gain(levels_x: int, levels_w: int, k: int) -> float:
    """Latch gain: codes -> normalized differential output z = y+ - y- in
    [-1, 1]: divide out both code ranges and the 2*N_in charge headroom."""
    return 1.0 / (float(levels_x) * float(levels_w) * 2.0 * max(k, 1))


def _record_window(cfg: TDVMMLayerConfig, x_codes: torch.Tensor,
                   w_codes: torch.Tensor, backend: str, code_dtype: str,
                   gain: float, max_code: Optional[int],
                   per_tile: bool = False,
                   group_widths: Optional[tuple[int, ...]] = None) -> None:
    """Calibration capture: when a ``core.calibration`` collector is active
    and the site has a digital readout boundary, record its latch-normalized
    max|z| — a scalar, the per-expert-tile ``(E,)`` vector when
    ``per_tile``, or the per-member ``(G,)`` vector over a ragged concat
    launch's column spans (``group_widths``) — exactly the window per-call
    data calibration would use.  Costs one extra codes matmul (B1 raw mode
    on the card) per site, paid only during the one-time calibration
    pass.

    Under ``collect(pinned=...)`` (a drift probe) the same pass also
    tallies the site's readout clip count — how many |z| elements exceed
    the pinned window — on the device, in the comparison ``z > window``
    the JAX package makes on the same float32 z."""
    from repro_torch.core import calibration
    if not calibration.active() or not cfg.io_quantize:
        return
    from repro_torch.kernels.tdvmm import ops
    with torch.no_grad():
        acc = ops.codes_matmul(x_codes, w_codes, backend,
                               code_dtype=code_dtype, max_code=max_code)
    _record_z(cfg, torch.abs(acc * _f32(gain)), per_tile, group_widths)


def _record_z(cfg: TDVMMLayerConfig, z: torch.Tensor, per_tile: bool,
              group_widths: Optional[tuple[int, ...]],
              tp_col: bool = False, dp_rows: bool = False,
              whole_cols: Optional[int] = None,
              counted: Optional[torch.Tensor] = None) -> None:
    """Record a site's |z| maxima (and clip tally) from its latch-normalized
    |z|.  ``tp_col``: ``z`` holds this rank's columns of a column-parallel
    site; ``dp_rows``: its rows of a batch split over the data axes.  The
    maxima are taken and clips counted over every such rank;
    ``whole_cols`` is the meshless launch's column count (a grouped
    launch's member spans pad to the 128 lane per shard); ``counted``
    (N,) marks the columns this rank's tally counts (a column several
    ranks hold is counted on the first of them)."""
    from repro_torch.core import calibration
    from repro_torch.launch import meshctx
    ref = calibration.clip_reference(cfg.site)
    if ref is not None:
        ref = ref.to(z.device)
        if group_widths is not None:
            # per-member windows expand to per-column thresholds; pad
            # columns threshold at +inf (zero charge, never a clip)
            cols = [ref.reshape(-1)[g].expand(wd)
                    for g, wd in enumerate(group_widths)]
            tail = z.shape[-1] - sum(group_widths)
            if tail > 0:
                cols.append(torch.full((tail,), float("inf"),
                                       device=z.device))
            thresh = torch.cat(cols)
        elif per_tile:
            thresh = ref.reshape(-1, 1, 1)
        else:
            thresh = ref.reshape(())
        over = z > thresh
        if counted is not None:
            over = over & counted.to(z.device)
        exceed, total = torch.sum(over), z.numel()
        if tp_col:
            exceed = meshctx.tp_sum_exact(exceed)
            total = (total // max(z.shape[-1], 1) * whole_cols
                     if whole_cols is not None
                     else total * meshctx.tp_size())
        if dp_rows:
            exceed = meshctx.dp_sum(exceed)
            total *= meshctx.dp_size()
        calibration.record_clip(cfg.site, exceed, total)

    def reduce(t):
        if tp_col:
            t = meshctx.tp_max(t)
        return meshctx.dp_max(t) if dp_rows else t
    if group_widths is not None:
        # member g owns columns [off, off + width_g); pad columns are zero
        # charge, so the span max equals the member's standalone max
        off, maxes = 0, []
        for wd in group_widths:
            maxes.append(_max0(z[..., off:off + wd]))
            off += wd
        calibration.record(cfg.site, reduce(torch.stack(maxes)))
        return
    if per_tile:
        calibration.record(cfg.site, reduce(
            torch.amax(z, dim=(-2, -1)).clamp_min(0.0)
            if z.numel() else z.new_zeros(z.shape[0])))
        return
    calibration.record(cfg.site, reduce(_max0(z)))


def _f32(v: float) -> float:
    """``v`` rounded to float32, as a Python scalar: a float32 tensor times
    it multiplies in float32 by exactly this value (what JAX does with a
    weakly typed constant), and no scalar tensor is copied to the card."""
    return float(np.float32(v))


def _operands(qx: quant.QuantizedTensor, qw: quant.QuantizedTensor,
              *inputs: torch.Tensor):
    """What the kernels get: the float32 straight-through views when an
    input (x or a weight) needs a gradient (QAT), else the stored codes."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return qx.view(), qw.view()
    return qx.codes, qw.codes


def _noise(cfg: TDVMMLayerConfig, key) -> bool:
    return bool(cfg.noise and key is not None)


def _max_code(qx, qw, code_dtype: str) -> Optional[int]:
    """The largest |code| of the two operands, for integer codes; None for
    noisy ones ("f32x3", off the integer grid)."""
    return None if code_dtype == "f32x3" else max(qx.levels, qw.levels)


def _max0(z: torch.Tensor) -> torch.Tensor:
    """max(z) with an initial value of 0 (``jnp.max(..., initial=0.0)``)."""
    zero = torch.zeros((), dtype=torch.float32, device=z.device)
    return torch.maximum(torch.amax(z), zero) if z.numel() else zero


# --------------------------------------------------------------------------
# Mesh sites: tensor parallelism and data-split rows
# --------------------------------------------------------------------------
# Under a mesh with a ``model`` axis > 1 a column-parallel site (N split:
# attn.qkv, ffn.in, moe gate/up, the head) holds its weights' columns, a
# row-parallel site (K split: attn.wo, ffn.out, moe down) its rows and the
# matching slice of x.  Each gives the bits of the meshless site:
#   * scales that are maxima over a split dim (a row site's per-row input
#     scale and per-channel weight scale; a per-tensor weight scale at
#     either kind) are all-reduced with MAX over ``model``;
#   * gain and rescale take the global K;
#   * a row site's raw accumulators (B1 raw mode) are summed over ``model``
#     exactly (int32, or float32 codes whose sums are integers), then the
#     epilogue runs once on the whole accumulator;
#   * a data-calibrated window and the calibration capture are maxima over
#     the whole output: over every ``model`` rank's columns at a column
#     site and, where the rows are one data shard's
#     (``meshctx.rows_split``), over every data rank's rows.  Such a site
#     integrates raw once, all-reduces its slot maxima with MAX and reads
#     out with that window (B1 fused on the card).  A site with a pinned
#     window (or none) runs its fused launch on its shard unchanged.
# TD-VMM training on a shard takes the reference's custom gradient on its
# operands: a column site's x gradient is a partial sum, all-reduced over
# ``model`` by the column input's ``meshctx.copy_to_tp``; a row site's
# gradients (``_RowCore``) are its own slices, x's and w's, from the
# cotangent of the whole (replicated) output.  Programming noise is drawn
# for the whole weight from the site's key and sliced (``_shard_noise``),
# so a shard's noisy codes are the meshless codes.
def _tp_mode(tp: Optional[str]) -> Optional[str]:
    from repro_torch.launch import meshctx
    if tp is None or not meshctx.tp_active():
        return None
    if tp not in ("col", "row"):
        raise ValueError(f"tensor-parallel mode {tp!r}")
    return tp


def _chunk_index(size: int) -> torch.Tensor:
    """This ``model`` rank's contiguous chunk of a dim of ``size`` per
    rank."""
    from repro_torch.launch import meshctx
    r = meshctx.tp_rank()
    return torch.arange(r * size, (r + 1) * size)


def _shard_noise(qw: quant.QuantizedTensor, cfg: TDVMMLayerConfig, key,
                 tp: Optional[str], shard=None) -> quant.QuantizedTensor:
    """``quant.program_noise`` on a shard's programmed bank (K, N) or (E,
    K, N): the draws of the whole bank (N or K times the ``model`` axis),
    sliced to the shard's columns (a column site) or rows (a row site):
    ``shard`` when given (the head-dim fallback's lanes), else its
    contiguous chunk."""
    if tp is None:
        return quant.program_noise(qw, cfg.spec, key)
    from repro_torch.launch import meshctx
    dim = -1 if tp == "col" else -2
    shape = list(qw.codes.shape)
    idx = _chunk_index(shape[dim]) if shard is None else shard
    shape[dim] *= meshctx.tp_size()
    idx = idx.to(qw.codes.device)
    return quant.program_noise(qw, cfg.spec, key, whole=tuple(shape),
                               select=lambda t: t.index_select(dim, idx))


class _RowCore(torch.autograd.Function):
    """A row site's epilogue on its accumulator summed over ``model``
    (``acc``), differentiable in this rank's operands: the reference's
    custom gradient (``ops._TDVMMCore``) with the STE through the readout,
    which gives each rank its slices of x's and w's gradients."""

    @staticmethod
    def forward(ctx, x3, w3, x_scale, w_scale, acc, out_window, static):
        gain, out_bits, out_scale, group_widths = static
        from repro_torch.kernels.tdvmm import ops
        e, m, n = acc.shape
        x_scale = x_scale.reshape(-1, m).to(torch.float32)
        w_scale = w_scale.reshape(e, n).to(torch.float32)
        ctx.save_for_backward(x3, w3, x_scale, w_scale)
        ctx.gain = gain
        return ops.epilogue(acc, x_scale, w_scale, gain, out_bits, out_scale,
                            out_window, group_widths)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels.tdvmm import ops
        x3, w3, x_scale, w_scale = ctx.saved_tensors
        need = ctx.needs_input_grad
        denom = x_scale[..., :, None] * w_scale[..., None, :]
        dacc = g * denom * float(np.float32(ctx.gain))
        gx, gw = ops._code_grads(dacc, x3.to(torch.float32),
                                 w3.to(torch.float32), need[0], need[1])
        return gx, gw, None, None, None, None, None


def _dp_rows() -> bool:
    from repro_torch.launch import meshctx
    return meshctx.rows_split()


def _tp_k(tp: Optional[str], k: int) -> int:
    """The global K of a site whose local K is ``k``."""
    if tp != "row":
        return k
    from repro_torch.launch import meshctx
    return k * meshctx.tp_size()


def _slot_max(z: torch.Tensor, group_widths) -> torch.Tensor:
    """Per readout slot max|z| of an (E, M, N) |z|: (E,), or (G,) over a
    ragged launch's member spans."""
    if group_widths is not None:
        spans = torch.split(z, list(group_widths), dim=-1)
        return torch.stack([torch.amax(t) for t in spans])
    return torch.amax(z, dim=(-2, -1))


def _mesh_integrate(tp: Optional[str], cfg: TDVMMLayerConfig, xc, wc,
                    x_scale, w_scale, gain: float, out_bits, out_scale,
                    out_window, backend: str, code_dtype: str, max_code,
                    tile, per_tile: bool = False, group_widths=None,
                    whole_cols: Optional[int] = None,
                    counted: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Integrate + readout of a site on a mesh (see above), its launches at
    the planned ``tile``.  Returns (E, M, N), or (M, N) for 2-D codes."""
    from repro_torch.core import calibration
    from repro_torch.kernels.tdvmm import ops
    from repro_torch.launch import meshctx
    capture = calibration.active() and cfg.io_quantize
    data_cal = out_bits is not None and out_scale is None \
        and out_window is None
    dp_rows = _dp_rows()
    squeeze = xc.dim() == 2 and wc.dim() == 2

    def reduce(s):
        if tp == "col":
            s = meshctx.tp_max(s)
        return meshctx.dp_max(s) if dp_rows else s

    if tp != "row" and not data_cal and not capture:
        return ops.tdvmm_matmul(
            xc, wc, x_scale, w_scale, gain=gain, out_bits=out_bits,
            out_scale=out_scale, backend=backend, code_dtype=code_dtype,
            group_widths=group_widths, out_window=out_window,
            max_code=max_code, tile=tile)
    x3 = xc[None] if xc.dim() == 2 else xc
    w3 = wc[None] if wc.dim() == 2 else wc
    with torch.no_grad():
        acc = ops.raw_acc(x3.detach(), w3.detach(), backend, code_dtype,
                          max_code, tile)
        if tp == "row":
            acc = meshctx.tp_sum_exact(acc)
        z = torch.abs(acc.to(torch.float32) * _f32(gain))
        if capture:
            _record_z(cfg, z[0] if squeeze else z, per_tile, group_widths,
                      tp_col=tp == "col", dp_rows=dp_rows,
                      whole_cols=whole_cols, counted=counted)
        if data_cal:
            out_window = torch.maximum(
                reduce(_slot_max(z, group_widths)),
                torch.full((), _f32(1e-9), dtype=torch.float32,
                           device=z.device))
    if tp == "row":
        y = _RowCore.apply(x3, w3, x_scale, w_scale, acc, out_window,
                           (gain, out_bits, out_scale, group_widths))
        return y[0] if squeeze else y
    return ops.tdvmm_matmul(
        xc, wc, x_scale, w_scale, gain=gain, out_bits=out_bits,
        out_scale=out_scale, backend=backend, code_dtype=code_dtype,
        group_widths=group_widths, out_window=out_window, max_code=max_code,
        tile=tile)


def td_matmul(x: torch.Tensor, w: torch.Tensor, cfg: TDVMMLayerConfig,
              key: Optional[quant.NoiseKey] = None,
              tp: Optional[str] = None, shard=None) -> torch.Tensor:
    """Four-quadrant TD-VMM fast path.  x: (..., N_in), w: (N_in, N_out).

    ``key`` with ``cfg.noise`` perturbs the programmed currents
    (``quant.program_noise``).  ``tp`` ("col" or "row") marks a
    tensor-parallel site's shard; it matters only under a mesh whose
    ``model`` axis is > 1 (a row site then returns the whole, reduced
    output on every rank).  ``shard``: the shard's columns (rows) within
    the whole weight when they are not its contiguous chunk (the noise
    draws' slice)."""
    if not cfg.enabled:
        return x @ w
    tp = _tp_mode(tp)
    noisy = _noise(cfg, key)
    kg = _tp_k(tp, w.shape[0])
    plan = plan_matmul(x.shape, w.shape, cfg, noisy=noisy, device=x.device,
                       k_global=kg)

    qx = quant.encode_input(x, cfg.bits, tp_reduce=tp == "row")
    qw = quant.program_weights(
        w, cfg.weight_bits, cfg.per_channel,
        tp_reduce=tp == "row" or (tp == "col" and not cfg.per_channel))
    if noisy:
        qw = _shard_noise(qw, cfg, key, tp, shard)

    from repro_torch.kernels.tdvmm import ops
    gain = _latch_gain(qx.levels, qw.levels, kg)
    # Digital rescale: per-row input range and per-channel 2*N_in*w_max.
    w_scale = torch.broadcast_to(
        qw.scale.reshape(-1) * _f32(2.0 * kg), (plan.n,))
    out_bits, out_scale = _readout_args(cfg)
    out_scale, out_window = _runtime_override(cfg, out_bits, out_scale)
    xc, wc = _operands(qx, qw, x, w)
    xc = xc.reshape(plan.m, plan.k)
    max_code = _max_code(qx, qw, plan.code_dtype)
    if tp is not None or _dp_rows():
        y = _mesh_integrate(tp, cfg, xc, wc, qx.scale.reshape(plan.m),
                            w_scale, gain, out_bits, out_scale, out_window,
                            plan.backend, plan.code_dtype, max_code,
                            plan.tile)
        return y.reshape(plan.batch_shape + (plan.n,)).to(x.dtype)
    _record_window(cfg, xc.detach(), wc.detach(), plan.backend,
                   plan.code_dtype, gain, max_code)
    y = ops.tdvmm_matmul(
        xc,
        wc,
        qx.scale.reshape(plan.m),
        w_scale,
        gain=gain,
        out_bits=out_bits,
        out_scale=out_scale,
        backend=plan.backend,
        code_dtype=plan.code_dtype,
        out_window=out_window,
        max_code=max_code,
        tile=plan.tile,
    )
    return y.reshape(plan.batch_shape + (plan.n,)).to(x.dtype)


def td_expert_matmul(x: torch.Tensor, w: torch.Tensor,
                     cfg: TDVMMLayerConfig,
                     key: Optional[quant.NoiseKey] = None,
                     tp: Optional[str] = None) -> torch.Tensor:
    """Batched four-quadrant TD-VMM: one analog tile per expert.

    x (E, C, N_in) is the MoE dispatch buffer, w (E, N_in, N_out) the
    stacked expert bank; one kernel launch covers every expert, with the
    expert dim on the batched grid axis, per-expert-per-row input scales,
    per-expert-per-channel weight scales and, once calibrated, an (E,)
    vector of readout windows.  Zero-padded (capacity) rows carry zero
    codes and contribute zero charge, so the padding is exact.  Without a
    gradient the bank is programmed a slice of experts at a time
    (``quant.program_weights``): the same bits in a slice's float32
    temporaries, so a full-width kimi-k2 bank fits on one card.  ``tp``
    as in ``td_matmul``."""
    if not cfg.enabled:
        return torch.einsum("eck,ekn->ecn", x, w)
    e, c, k = x.shape
    e2, k2, n = w.shape
    if e != e2 or k != k2:
        raise ValueError(f"td_expert_matmul shapes {tuple(x.shape)} x "
                         f"{tuple(w.shape)}")
    tp = _tp_mode(tp)
    noisy = _noise(cfg, key)
    kg = _tp_k(tp, k)
    code_dtype = _plan_code_dtype(cfg, kg, noisy)
    from repro_torch.kernels.tdvmm import ops
    # the expert grid is keyed by its per-expert rows, E not in the key
    kp = ops.plan_kernel(cfg.backend, c, k, n, code_dtype, x.device)
    backend = kp.backend

    qx = quant.encode_input(x, cfg.bits,                        # scale (E, C, 1)
                            tp_reduce=tp == "row")
    qw = quant.program_weights(
        w, cfg.weight_bits, cfg.per_channel,
        tp_reduce=tp == "row" or (tp == "col" and not cfg.per_channel))
    if noisy:
        qw = _shard_noise(qw, cfg, key, tp)
    gain = _latch_gain(qx.levels, qw.levels, kg)
    # qw.scale is (E, 1, N) per-channel or (E, 1, 1) per-tensor
    w_scale = torch.broadcast_to(
        qw.scale.reshape(e, qw.scale.shape[-1]) * _f32(2.0 * kg), (e, n))
    out_bits, out_scale = _readout_args(cfg, n_experts=e)
    out_scale, out_window = _runtime_override(cfg, out_bits, out_scale)
    # each expert is its own analog tile: calibration records (E,) windows
    max_code = _max_code(qx, qw, code_dtype)
    xc, wc = _operands(qx, qw, x, w)
    if tp is not None or _dp_rows():
        return _mesh_integrate(tp, cfg, xc, wc, qx.scale.reshape(e, c),
                               w_scale, gain, out_bits, out_scale,
                               out_window, backend, code_dtype, max_code,
                               kp.tile, per_tile=True).to(x.dtype)
    _record_window(cfg, xc.detach(), wc.detach(), backend, code_dtype, gain,
                   max_code, per_tile=True)
    y = ops.tdvmm_matmul(
        xc,
        wc,
        qx.scale.reshape(e, c),
        w_scale,
        gain=gain,
        out_bits=out_bits,
        out_scale=out_scale,
        backend=backend,
        code_dtype=code_dtype,
        out_window=out_window,
        max_code=max_code,
        tile=kp.tile,
    )
    return y.to(x.dtype)


def td_grouped_matmul(x: torch.Tensor, ws, cfg: TDVMMLayerConfig,
                      key: Optional[quant.NoiseKey] = None,
                      tp: Optional[str] = None, shard=None, replicas=None
                      ) -> tuple[torch.Tensor, ...]:
    """Grouped four-quadrant TD-VMM: G same-input projections, one launch.

    ``x`` (..., N_in) is encoded once and the G matrices (N_in, N_g) run as
    one **ragged concat** launch: the members concatenate along N into one
    2-D (K, sum widths) bank, each member rounded up to the 128 lane only.
    Per-member per-channel weight scales concatenate into the epilogue's
    per-column scale row, and per-member readout windows resolve by column
    span (``group_widths``), so the launch is bitwise the G sequential calls
    whenever the windows match.  Programming noise perturbs the concat bank
    (as the JAX package does; on a column shard, its columns of the whole
    bank's draws: each member's contiguous chunk, or ``shard[g]`` where it
    is not None).  ``replicas[g]``: the consecutive ``model`` ranks that
    hold the same columns of member g (the KV groups split's ``wk`` /
    ``wv``: one KV head a rank), whose whole width is then N_g x tp /
    replicas[g], and whose clips the first of them counts.
    Returns G tensors shaped (..., N_g)."""
    ws = tuple(ws)
    if not ws:
        return ()
    if not cfg.enabled:
        return tuple(x @ w for w in ws)
    k = x.shape[-1]
    ns = tuple(w.shape[-1] for w in ws)
    for w in ws:
        if w.dim() != 2 or w.shape[0] != k:
            raise ValueError(f"grouped member {tuple(w.shape)} for an input "
                             f"of width {k}")
    tp = _tp_mode(tp)
    if tp == "row":
        raise ValueError("a grouped site is column-parallel")
    noisy = _noise(cfg, key)
    from repro_torch.kernels.tdvmm import ops, tdvmm
    # per-member column spans: each member rounds to the 128 lane only
    widths = tuple(tdvmm.padded_size(n, tdvmm.LANE, tdvmm.LANE) for n in ns)
    n_total = sum(widths)
    plan = plan_matmul(x.shape, (k, n_total), cfg, noisy=noisy,
                       device=x.device)

    qx = quant.encode_input(x, cfg.bits)                       # encode ONCE
    qw = quant.concat_group(
        [quant.program_weights(w, cfg.weight_bits, cfg.per_channel,
                               tp_reduce=tp is not None
                               and not cfg.per_channel)
         for w in ws], widths)
    reps = (1,) * len(ws) if replicas is None else tuple(replicas)
    if noisy:
        qw = _group_noise(qw, cfg, key, tp, ns, widths, shard, reps)
    gain = _latch_gain(qx.levels, qw.levels, k)
    w_scale = qw.scale.reshape(n_total) * _f32(2.0 * k)
    out_bits, out_scale = _readout_args(cfg, n_experts=len(ws))
    out_scale, out_window = _runtime_override(cfg, out_bits, out_scale)
    xc, wc = _operands(qx, qw, x, *ws)
    xc = xc.reshape(plan.m, k)
    # each member's column span is its own analog tile: calibration records
    # one (G,) vector for the site
    max_code = _max_code(qx, qw, plan.code_dtype)
    if tp is not None or _dp_rows():
        whole = counted = None
        if tp is not None:
            from repro_torch.launch import meshctx
            n_tp, r = meshctx.tp_size(), meshctx.tp_rank()
            whole = sum(tdvmm.padded_size(n * n_tp // rp, tdvmm.LANE,
                                          tdvmm.LANE)
                        for n, rp in zip(ns, reps))
            if any(rp > 1 for rp in reps):
                counted = torch.cat([torch.full((wd,), r % rp == 0)
                                     for wd, rp in zip(widths, reps)])
        y = _mesh_integrate(tp, cfg, xc, wc, qx.scale.reshape(plan.m),
                            w_scale, gain, out_bits, out_scale, out_window,
                            plan.backend, plan.code_dtype, max_code,
                            plan.tile, group_widths=widths, whole_cols=whole,
                            counted=counted)
    else:
        _record_window(cfg, xc.detach(), wc.detach(), plan.backend,
                       plan.code_dtype, gain, max_code, group_widths=widths)
        y = ops.tdvmm_matmul(
            xc,
            wc,
            qx.scale.reshape(plan.m),
            w_scale,
            gain=gain,
            out_bits=out_bits,
            out_scale=out_scale,
            backend=plan.backend,
            code_dtype=plan.code_dtype,
            group_widths=widths,
            out_window=out_window,
            max_code=max_code,
            tile=plan.tile,
        )                                                      # (M, n_total)
    outs, off = [], 0
    for n, wd in zip(ns, widths):
        outs.append(y[:, off:off + n].reshape(plan.batch_shape + (n,))
                    .to(x.dtype))
        off += wd
    return tuple(outs)


def _group_noise(qw, cfg: TDVMMLayerConfig, key, tp, ns, widths, shard,
                 replicas=None):
    """Noise on a grouped launch's concat bank; on a column shard the
    draws of the meshless concat bank (each member's whole width, N_g x
    tp / replicas[g], rounded to the 128 lane), at the shard's columns
    (pad columns hold zero codes, which noise leaves zero: they take any
    draw)."""
    if tp is None:
        return quant.program_noise(qw, cfg.spec, key)
    from repro_torch.kernels.tdvmm import tdvmm
    from repro_torch.launch import meshctx
    n_tp = meshctx.tp_size()
    replicas = replicas or (1,) * len(ns)
    cols, off = [], 0
    for g, (n, wd) in enumerate(zip(ns, widths)):
        idx = _chunk_index(n) if shard is None or shard[g] is None \
            else shard[g]
        cols += [off + idx, torch.full((wd - n,), off, dtype=torch.long)]
        off += tdvmm.padded_size(n * n_tp // replicas[g], tdvmm.LANE,
                                 tdvmm.LANE)
    idx = torch.cat(cols).to(qw.codes.device)
    return quant.program_noise(qw, cfg.spec, key,
                               whole=(qw.codes.shape[0], off),
                               select=lambda t: t.index_select(-1, idx))


def calibrate_out_scale(x: torch.Tensor, w: torch.Tensor,
                        cfg: TDVMMLayerConfig,
                        key: Optional[quant.NoiseKey] = None) -> float:
    """Serving-path readout calibration: capture the ADC window once.

    Runs encode -> program -> integrate on a representative batch and returns
    max|z| of the latch-normalized accumulation (the §3.1 output-window
    calibration) as a Python float; store it with
    ``cfg.replace(out_scale=...)`` to pin the window.  With ``cfg.noise``
    and a ``key`` the window is captured over the noisy codes the site will
    integrate (a noise-free one would clip them)."""
    if not cfg.enabled:
        raise ValueError("calibrate_out_scale needs an enabled TD-VMM config")
    noisy = _noise(cfg, key)
    plan = plan_matmul(x.shape, w.shape, cfg, noisy=noisy, device=x.device)
    with torch.no_grad():
        qx = quant.encode_input(x, cfg.bits)
        qw = quant.program_weights(w, cfg.weight_bits, cfg.per_channel)
        if noisy:
            qw = quant.program_noise(qw, cfg.spec, key)
        from repro_torch.kernels.tdvmm import ops
        acc = ops.codes_matmul(qx.codes.reshape(plan.m, plan.k), qw.codes,
                               plan.backend, code_dtype=plan.code_dtype,
                               max_code=_max_code(qx, qw, plan.code_dtype))
    gain = _latch_gain(qx.levels, qw.levels, plan.k)
    z_max = _max0(torch.abs(acc * _f32(gain)))
    return max(float(z_max), 1e-9)


def init_linear(generator: Optional[torch.Generator], d_in: int, d_out: int,
                dtype=torch.float32, scale: Optional[float] = None,
                device=None) -> torch.Tensor:
    """A (d_in, d_out) weight: standard normal draws from ``generator``
    (torch's default generator when None) times ``scale``, by default
    1 / sqrt(d_in), in ``dtype``; on ``device``, by default the
    generator's."""
    if device is None and generator is not None:
        device = generator.device
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator, device=device)
    return (w * scale).to(dtype)


class TDVMMLinear(torch.nn.Module):
    """The paper's multiplier as a linear layer: ``td_matmul(x, w, cfg)``
    plus an optional bias.  ``w`` is (d_in, d_out), the JAX package's
    layout; ``b`` is (d_out,), zeros at construction.

    ``calibrate`` captures the readout window on a representative batch and
    returns the config that pins it; assign it to ``cfg`` to serve with the
    window fixed (on the card: B1 fused, where an unpinned window takes
    B2)."""

    def __init__(self, d_in: int, d_out: int, cfg: TDVMMLayerConfig,
                 bias: bool = False, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        self.w = torch.nn.Parameter(
            init_linear(generator, d_in, d_out, dtype, device=device))
        self.register_parameter("b", torch.nn.Parameter(torch.zeros(
            d_out, dtype=dtype, device=self.w.device)) if bias else None)

    @classmethod
    def from_params(cls, params: dict, cfg: TDVMMLayerConfig,
                    device=None) -> "TDVMMLinear":
        """The layer holding the JAX package's parameters ``{"w": (d_in,
        d_out)[, "b": (d_out,)]}`` given as numpy arrays, each in its own
        dtype (bfloat16 stays bfloat16)."""
        from repro_torch import convert
        w = convert.leaf_from_numpy(params["w"], device)
        layer = cls(*w.shape, cfg, bias="b" in params, dtype=w.dtype,
                    device="meta")
        layer.w = torch.nn.Parameter(w)
        if "b" in params:
            layer.b = torch.nn.Parameter(
                convert.leaf_from_numpy(params["b"], device))
        return layer

    def forward(self, x: torch.Tensor,
                key: Optional[quant.NoiseKey] = None) -> torch.Tensor:
        y = td_matmul(x, self.w, self.cfg, key)
        return y if self.b is None else y + self.b

    def calibrate(self, x: torch.Tensor,
                  key: Optional[quant.NoiseKey] = None) -> TDVMMLayerConfig:
        """``cfg`` with ``out_scale`` pinned to the window captured on
        ``x`` (``calibrate_out_scale``; pass ``key`` on a noisy config so
        the window covers the perturbed currents).  The layer is not
        changed."""
        return self.cfg.replace(
            out_scale=calibrate_out_scale(x, self.w, self.cfg, key))
