"""Quantized-code subsystem (serving path): encode -> program -> codes.

The paper's multiplier is an *integer-code* machine: p-bit time codes in,
current codes as weights, charge accumulation, p-bit readout.  This module
holds the two code stages the serving path runs before the TD-VMM kernel:

    encode_input      Eq. 2 / section 4.2 — the shared-counter DAC converts a
                      normalized activation into a p-bit rising-edge time code
                      (sign = differential wire pair), per-row range scale.
    program_weights   sections 2, 4.1 — floating-gate tuning programs each
                      cell's current to one of 2^p_w levels, per-output-column
                      scale (an expert bank without a gradient, a slice of
                      experts at a time).
    readout           Eq. 3 / section 4.2 — the p-bit ADC over an output
                      window, in the value domain.

Codes are **bitwise** those of the JAX package (``repro.core.quant``): the
normalization is the division ``xf / s`` (never a reciprocal multiply), the
scale is ``max(max|x| with initial 0, 1e-6)``, and rounding is half to even.
Every constant enters as an explicit float32 tensor, so no double-precision
scalar arithmetic sneaks in.  ``concat_group`` joins G programmed members
into the ragged bank of a grouped launch; ``stack_group`` stacks them into
a (G, K, N) bank, as the JAX package's public API does.

Storage: int8 for p <= 7; integer-valued float32 for p = 8 (``signed_codes``,
the JAX package's straight-through form ``lin + detach(q - lin)``, whose
forward value is the rounded code).  ``pack_int4`` / ``unpack_int4`` hold
p <= 3 codes two per byte, the layout kernel B1 streams in its int4 mode.

Gradients (QAT): every quantizer is a straight-through estimator.  When the
input needs a gradient, ``encode_input`` / ``program_weights`` keep the
unrounded linear term ``x * L`` beside int8 codes, and
``QuantizedTensor.view()`` splices it in as ``qf + (ste - detach(ste))``:
forward the integer code bit for bit, backward the identity.  Scales are
detached.  ``program_noise`` perturbs programmed currents (DIBL and tuning
noise): its codes are float32 and not integers.  A noise ``key`` is an int
seed (the draws come from a generator seeded by it, so the same key draws
the same noise, also when a checkpointed block is recomputed) or a
``NoiseDraws`` pair handed in from outside.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import encoding as enc
from repro_torch.runtime.trace import span

# Signed-magnitude codes span [-(2^p - 1), 2^p - 1]: int8 holds p <= 7.
INT8_MAX_BITS = 7
# A signed nibble holds [-8, 7] ⊇ [-7, 7]: p <= 3 packs two codes per byte.
INT4_MAX_BITS = 3


def storage_dtype(bits: int) -> torch.dtype:
    """Canonical code storage: int8 when the signed code range fits."""
    return torch.int8 if bits <= INT8_MAX_BITS else torch.float32


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """Integer codes + the scale that maps them back to model units.

    codes:  int8 in [-levels, levels] (p <= 7), else float32: integer
            valued, straight-through wrapped, or (``program_noise``) not on
            the integer grid.
    scale:  f32, per-row ``(..., 1)`` for activations, per-channel ``(1, N)``
            or per-tensor ``(1, 1)`` for weights; detached.
    bits:   code width p.
    ste:    the unrounded float32 linear term ``x * L`` kept beside int8
            codes when the input needs a gradient (QAT), else None.
    """

    codes: torch.Tensor
    scale: torch.Tensor
    bits: int
    ste: Optional[torch.Tensor] = None

    @property
    def levels(self) -> int:
        return (1 << self.bits) - 1

    def view(self) -> torch.Tensor:
        """float32 straight-through view of the codes: forward the stored
        codes, backward the identity (through ``ste`` when present)."""
        if self.codes.dtype.is_floating_point:
            return self.codes          # float32 codes carry their STE
        qf = self.codes.to(torch.float32)
        if self.ste is None:
            return qf
        # qf + (ste - detach(ste)), not ste + detach(qf - ste): the
        # correction is exactly +0.0, so the forward value is the integer
        # code and float sums over integer products stay order-free (the
        # other form rounds twice and lands an ulp off the grid)
        return qf + (self.ste - self.ste.detach())

    def dequantize(self) -> torch.Tensor:
        """Back to model units: codes / L * scale."""
        return self.view() * (self.scale / float(self.levels))


def pack_int4(codes: torch.Tensor, axis: int) -> torch.Tensor:
    """Pack int8 codes with |code| <= 7 (p <= 3) two per byte along ``axis``.

    Byte ``kp`` holds code ``2 kp`` in the low nibble and ``2 kp + 1`` in the
    high nibble; an odd-length axis is zero-padded first (a zero code is an
    inert current source).  Returns int8 of half the (even) extent."""
    axis = axis % codes.dim()
    if codes.shape[axis] % 2:
        pad = [0, 0] * (codes.dim() - 1 - axis) + [0, 1]
        codes = F.pad(codes, pad)
    codes = codes.to(torch.int8)
    lo = codes[(slice(None),) * axis + (slice(0, None, 2),)]
    hi = codes[(slice(None),) * axis + (slice(1, None, 2),)]
    return (lo & 0x0F) | (hi << 4)


def unpack_int4(packed: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """Inverse of ``pack_int4``: int8 nibble pairs -> ``k`` int8 codes along
    ``axis``.  Arithmetic shifts sign-extend the nibbles: (v << 4) >> 4 for
    the low one, v >> 4 for the high one."""
    axis = axis % packed.dim()
    packed = packed.to(torch.int8)
    lo = (packed << 4) >> 4
    hi = packed >> 4
    out = torch.stack([lo, hi], dim=axis + 1)
    shape = list(packed.shape)
    shape[axis] = 2 * packed.shape[axis]
    return out.reshape(shape).narrow(axis, 0, k)


def ste(x_quant: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: forward ``x_quant``, backward identity."""
    return x + (x_quant - x).detach()


def signed_codes(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Value in [-1, 1] -> integer-valued float32 code in [-L, L].

    A straight-through estimator in the code domain, as the JAX package
    writes it: ``lin + detach(q - lin)`` with ``lin = x * L``, so the
    forward value is the rounded code (bitwise the JAX package's) and
    d(code)/dx = L."""
    levels = float((1 << bits) - 1)
    q = enc.quantize_code_signed(x, bits).to(torch.float32)
    return ste(q, x * levels)


def _store(normalized: torch.Tensor, bits: int
           ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(codes, ste) for a normalized value in [-1, 1]: int8 codes, with the
    float32 linear term when a gradient is needed; else straight-through
    float32 codes (``signed_codes``) and no separate term."""
    if storage_dtype(bits) == torch.int8:
        codes = enc.quantize_code_signed(normalized, bits).to(torch.int8)
        lin = None
        if normalized.requires_grad and torch.is_grad_enabled():
            lin = normalized * float((1 << bits) - 1)
        return codes, lin
    return signed_codes(normalized, bits), None


def _floor(t: torch.Tensor, value: float) -> torch.Tensor:
    # a float32 tensor against a Python scalar: the bound is rounded to
    # float32, as jnp.maximum does with a weakly typed constant; NaN stays NaN
    return torch.clamp_min(t, value)


def _absmax(xf: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
    """max|x| over ``dims`` with keepdims and an initial value of 0 (so a
    zero-size reduction gives 0, as ``jnp.max(..., initial=0.0)`` does)."""
    if xf.numel() == 0:
        shape = list(xf.shape)
        for d in dims:
            shape[d] = 1
        return torch.zeros(shape, dtype=torch.float32, device=xf.device)
    return _floor(torch.amax(torch.abs(xf), dim=dims, keepdim=True), 0.0)


def _tp_max(t: torch.Tensor, tp_reduce: bool) -> torch.Tensor:
    if not tp_reduce:
        return t
    from repro_torch.launch import meshctx
    return meshctx.tp_max(t)


def encode_input(x: torch.Tensor, bits: int, axis: int = -1,
                 tp_reduce: bool = False) -> QuantizedTensor:
    """Input stage (Eq. 2): per-row range normalization + p-bit time codes.

    The scale is the per-example input range max|x| along ``axis`` (the
    analog front-end normalizes each sample into the [0, T] window).
    ``tp_reduce``: ``axis`` is split over the mesh's ``model`` axis (a
    row-parallel site), so the max is taken over every rank's slice.
    """
    xf = x.to(torch.float32)
    s = _floor(_tp_max(_absmax(xf.detach(), (axis,)), tp_reduce), 1e-6)
    codes, lin = _store(xf / s, bits)
    return QuantizedTensor(codes=codes, scale=s, bits=bits, ste=lin)


def program_weights(
    w: torch.Tensor, bits: int, per_channel: bool = True,
    tp_reduce: bool = False
) -> QuantizedTensor:
    """Weight stage (sections 2, 4.1): FG current codes + column scaling.

    ``per_channel`` scales each output column independently (axis -2 of a
    (N_in, N_out) matrix); otherwise one scale per weight tile.

    An (E, K, N) expert bank that takes no gradient (serving, calibration,
    the drift probe) is programmed a slice of experts at a time into
    preallocated codes and scales.  Every scale is per expert, so the bits
    are those of the whole bank at once: a change of memory, not of
    numbers.  A whole bank's float32 copy, its ``abs`` and its normalized
    value take 4 bytes a weight apiece (22.5 GB each for one of kimi-k2's
    384 x 7168 x 2048 banks); a slice keeps each near ``SLICE_ELEMS``.
    With a gradient the straight-through term spans the whole tensor.
    ``tp_reduce``: a reduced dim is split over the mesh's ``model`` axis,
    so each scale is the max over every rank's slice.
    """
    with span("tdvmm.program"):
        if w.dim() == 3 and not (w.requires_grad
                                 and torch.is_grad_enabled()):
            step = expert_step(w)
            if step < w.shape[0]:
                e, _, n = w.shape
                codes = torch.empty(w.shape, dtype=storage_dtype(bits),
                                    device=w.device)
                scale = torch.empty((e, 1, n if per_channel else 1),
                                    dtype=torch.float32, device=w.device)
                for lo in range(0, e, step):
                    q = _program(w[lo:lo + step], bits, per_channel,
                                 tp_reduce)
                    codes[lo:lo + step] = q.codes
                    scale[lo:lo + step] = q.scale
                return QuantizedTensor(codes=codes, scale=scale, bits=bits)
        return _program(w, bits, per_channel, tp_reduce)


def _program(w: torch.Tensor, bits: int, per_channel: bool,
             tp_reduce: bool = False) -> QuantizedTensor:
    wf = w.to(torch.float32)
    dims = (-2,) if per_channel else (-2, -1)
    w_max = _floor(_tp_max(_absmax(wf.detach(), dims), tp_reduce), 1e-6)
    # no clip here: the stored code clips to the code range, and the STE
    # linear term stays unclipped (a clip would halve the gradient of every
    # per-channel max-magnitude weight, a min/max tie at |w| == w_max)
    codes, lin = _store(wf / w_max, bits)
    return QuantizedTensor(codes=codes, scale=w_max, bits=bits, ste=lin)


# Elements of one slice of an (E, K, N) expert bank: 1 GiB of each float32
# temporary of ``program_weights`` and 2 GiB of each float64 one of the
# plain product on the card (``tdvmm.acc_plain``); 18 of kimi-k2's
# 7168 x 2048 experts.
SLICE_ELEMS = 1 << 28


def expert_step(w: torch.Tensor) -> int:
    """Experts in one slice of the (E, K, N) bank ``w``."""
    return max(1, SLICE_ELEMS // max(w[0].numel(), 1))


def stack_group(qws, n_to: int) -> QuantizedTensor:
    """Stack G programmed (K, N_g) members into one (G, K, ``n_to``) bank.

    Uneven widths are zero-padded up to ``n_to``: zero codes are inert (a
    never-on current source), so pad columns integrate zero charge, and
    their scale entries are 1.0 (never multiplied against a nonzero code).
    Members share the code width; per-channel ``(1, N_g)`` and per-tensor
    ``(1, 1)`` scales both stack to a ``(G, 1, n_to)`` scale, and STE
    linear terms stack beside the codes, zero-padded.  Nothing in either
    package calls it (grouped launches take ``concat_group``'s ragged
    bank); it is kept as the JAX package's public API."""
    qws = tuple(qws)
    if not qws:
        raise ValueError("stack_group needs at least one member")
    bits = qws[0].bits
    if any(q.bits != bits for q in qws):
        raise ValueError(f"grouped members must share a code width, got "
                         f"{[q.bits for q in qws]}")
    if any(q.codes.dim() != 2 for q in qws):
        raise ValueError("stack_group stacks 2-D (K, N) weight members")
    if any(q.codes.shape[-1] > n_to for q in qws):
        raise ValueError(f"n_to={n_to} smaller than a member width "
                         f"{[q.codes.shape[-1] for q in qws]}")

    def pad(t):
        return F.pad(t, (0, n_to - t.shape[-1]))

    codes = torch.stack([pad(q.codes) for q in qws])
    scale = torch.stack([F.pad(
        torch.broadcast_to(q.scale, (1, q.codes.shape[-1])),
        (0, n_to - q.codes.shape[-1]), value=1.0) for q in qws])
    stes = None
    if all(q.ste is not None for q in qws):
        stes = torch.stack([pad(q.ste) for q in qws])
    return QuantizedTensor(codes=codes, scale=scale, bits=bits, ste=stes)


def concat_group(qws, widths: tuple[int, ...]) -> QuantizedTensor:
    """Concatenate G programmed (K, N_g) members along N into one ragged bank.

    The ragged grouped launch (``core.layers.td_grouped_matmul``) runs one
    shared input against the column concat of G same-input projections:
    member g owns a ``widths[g]``-wide column span (its width rounded up to
    the 128 lane).  Pad columns carry zero codes, which integrate zero
    charge, and scale 1.0, which only ever multiplies a zero output."""
    qws = tuple(qws)
    if not qws:
        raise ValueError("concat_group needs at least one member")
    if len(widths) != len(qws):
        raise ValueError(f"{len(widths)} widths for {len(qws)} members")
    bits = qws[0].bits
    if any(q.bits != bits for q in qws):
        raise ValueError(f"grouped members must share a code width, got "
                         f"{[q.bits for q in qws]}")
    if any(q.codes.dim() != 2 for q in qws):
        raise ValueError("concat_group concatenates 2-D (K, N) members")
    if any(q.codes.shape[-1] > wd for q, wd in zip(qws, widths)):
        raise ValueError(
            f"member widths {[q.codes.shape[-1] for q in qws]} exceed the "
            f"declared spans {tuple(widths)}")
    codes = torch.cat([F.pad(q.codes, (0, wd - q.codes.shape[-1]))
                       for q, wd in zip(qws, widths)], dim=-1)
    scale = torch.cat([F.pad(
        torch.broadcast_to(q.scale, (1, q.codes.shape[-1])),
        (0, wd - q.codes.shape[-1]), value=1.0)
        for q, wd in zip(qws, widths)], dim=-1)
    stes = None
    if all(q.ste is not None for q in qws):
        stes = torch.cat([F.pad(q.ste, (0, wd - q.ste.shape[-1]))
                          for q, wd in zip(qws, widths)], dim=-1)
    return QuantizedTensor(codes=codes, scale=scale, bits=bits, ste=stes)


class NoiseDraws(NamedTuple):
    """The two draws of ``program_noise``, handed in from outside: ``u``
    uniform in [-1, 1) and ``normal`` standard normal, both float32 of the
    programmed codes' shape (a test feeds the JAX package's own draws)."""
    u: torch.Tensor
    normal: torch.Tensor


NoiseKey = Union[int, NoiseDraws]


def split_key(key: int, n: int) -> tuple[int, ...]:
    """``n`` independent int keys derived from ``key`` (the counterpart of
    ``jax.random.split``: a function of the key alone)."""
    state = np.random.SeedSequence(int(key)).generate_state(n, np.uint64)
    return tuple(int(v) >> 1 for v in state)


def fold_in(key: int, data: int) -> int:
    """An int key derived from ``key`` and ``data`` (the counterpart of
    ``jax.random.fold_in``: a function of both alone)."""
    if not isinstance(key, int) or isinstance(key, bool):
        raise TypeError("fold_in takes an int key (handed-in NoiseDraws "
                        "cannot be split across ranks)")
    state = np.random.SeedSequence([int(key), int(data)]).generate_state(
        1, np.uint64)
    return int(state[0]) >> 1


def noise_draws(key: NoiseKey, shape, device) -> NoiseDraws:
    """The draws for one programmed bank: those handed in, or two draws
    from a generator on ``device`` seeded by ``key`` alone."""
    if isinstance(key, NoiseDraws):
        if tuple(key.u.shape) != tuple(shape) or \
                tuple(key.normal.shape) != tuple(shape):
            raise ValueError(f"noise draws of shape {tuple(key.u.shape)} and "
                             f"{tuple(key.normal.shape)} for codes {tuple(shape)}")
        return NoiseDraws(key.u.to(device, torch.float32),
                          key.normal.to(device, torch.float32))
    if isinstance(key, bool) or not isinstance(key, int):
        raise TypeError(f"a noise key is an int seed or NoiseDraws, got "
                        f"{type(key).__name__}")
    gen = torch.Generator(device=device)
    gen.manual_seed(key)
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32,
                   device=device) * 2.0 - 1.0
    normal = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                         device=device)
    return NoiseDraws(u, normal)


def program_noise(qw: QuantizedTensor, spec, key: NoiseKey,
                  whole=None, select=None) -> QuantizedTensor:
    """Stochastic DIBL + FG tuning noise on programmed current codes:
    ``codes = view * (1 + err * u) * exp(0.003 * normal)``.

    Multiplicative, so it is the same in the code and value domains; the
    perturbed codes are not integers (analog currents), so the result
    always carries float32 codes, through which the straight-through
    gradient of ``view()`` flows.  ``whole`` and ``select``: ``qw`` is a
    tensor-parallel shard of a bank of shape ``whole``; the draws are made
    for the whole bank and ``select`` takes the shard's, so its noisy
    codes are the meshless bank's."""
    from repro_torch.core import nonideal

    err = float(nonideal.relative_error(spec.i_max, spec.v_sg, spec.delta_vd))
    view = qw.view()
    if whole is None:
        d = noise_draws(key, view.shape, view.device)
    else:
        d = noise_draws(key, whole, view.device)
        d = NoiseDraws(select(d.u), select(d.normal))
    codes = view * (1.0 + float(np.float32(err)) * d.u)
    codes = codes * torch.exp(float(np.float32(0.003)) * d.normal)
    return QuantizedTensor(codes=codes, scale=qw.scale, bits=qw.bits)


def readout(y: torch.Tensor, bits: int, scale=None) -> torch.Tensor:
    """Readout stage (Eq. 3 / section 4.2): p-bit ADC over the output window,
    in the value domain.  ``scale=None`` calibrates the window to
    max(max|y|, 1e-9) (section 3.1, detached); a float or tensor fixes it.
    Forward the quantized value, backward the identity (STE)."""
    if scale is None:
        scale = _floor(_absmax(y.detach().to(torch.float32),
                               tuple(range(y.dim()))), 1e-9).reshape(())
    levels = float((1 << bits) - 1)
    return signed_codes(y / scale, bits) * (scale / levels)
