"""TD-VMM kernels B1 and B2 for Hopper, their plain torch versions, and
launch counters.

B1 (``csrc/tdvmm.cu``) replaces the Pallas ``tdvmm._kernel``: charge
accumulation with the K walk inside the CTA on Hopper's tensor cores
(``mma.sync``), and the fused gain -> optional p-bit readout -> rescale
epilogue straight from the accumulator fragments.  Modes: raw accumulator out
(``tdvmm_matmul_raw``), fused with or without a readout over a fixed
per-column window (``tdvmm_fused``).  B2 (``csrc/tdvmm_calib.cu``) replaces
``tdvmm._calib_kernel``: the data-calibrated readout, as two launches over
one output buffer (``tdvmm_calibrated``).  Both take batched
(E, M, K) x (E, K, N) codes (the MoE expert grid) or shared-x
(1, M, K) x (E, K, N), in the Pallas kernel's three code storages:

    int8   int8 codes, s8 x s8 -> s32 MMA, exact int32 accumulation
           (p <= 7);
    int4   p <= 3 codes packed two per byte along K (``quant.pack_int4``;
           pass the code depth as ``int4_k``), streamed packed and unpacked
           on chip into the same s8 MMA, bitwise the int8 result;
    f32    integer-valued float32 codes (p = 8), streamed as float32 and
           rounded to bf16 on chip for a bf16 x bf16 -> f32 MMA.  Exact
           while every code fits bf16 (|code| <= 256, from the ``max_code``
           the caller passes) and worst |acc| < 2^24 (the envelope
           ``core.layers`` warns on): every product and every partial sum
           is then an integer float32 holds;
    f32x3  float32 codes on the TF32 tensor cores in three products
           (3xTF32: each code split into TF32 hi and lo parts, lo.hi +
           hi.lo + hi.hi), each 32-deep K stage summed from zero and added
           into the total with one IEEE add.  It takes the codes the bf16
           tile cannot: codes off the integer grid (programming noise; the
           caller asks for them with ``code_dtype="f32x3"``), within
           float32 rounding of the plain version (``F32X3_RTOL``), and
           integer codes up to |2047| (p = 9-11), which TF32 holds exactly
           (the lo parts are zero), bitwise while worst |acc| < 2^24
           (``check_code_width`` sends them here).

Each launch takes one of two CTA tiles (``TILES``: 16 x 64 and 128 x
128) from one lookup, ``autotune_lookup``: the per-shape table measured on
an H100 (``autotune_table.py``, written by ``launch/autotune_tdvmm.py``),
keyed by the unpadded (M, K, N, storage name), and on a miss the rule by M
alone (``plan_tile``: 16 x 64 up to 256 rows, 128 x 128 beyond).  A caller
that planned a tile (``ops.plan_kernel``) passes it as ``tile=``.  Which
tile a launch takes never changes its bits on integer codes.  What bounds
them on the card: device-memory bytes at decode (the weight codes); at
thousands of rows, staging the codes through shared memory (for float32
codes, their 4 bytes each), well below the tensor-core rate.

Every wrapper follows one rule: a tensor on the CPU goes to the plain
version beside it (same arithmetic in torch ops, exact accumulation); a
tensor on the card goes to the kernel, or the wrapper raises.  There is no
fallback.  ``LAUNCHES`` counts kernel launches only, per wrapper and code
storage (``"fused"`` is int8, ``"fused_f32"`` and ``"fused_int4"`` the
others); ``TILE_LAUNCHES`` counts them per lookup key and tile.

The kernels are built at first use with ``nvcc`` for ``sm_90a`` into the
port's kernel build directory (``kernels/_build.py``: one shared library
per source, built in parallel) and bound with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.kernels import _build, hooks
from repro_torch.kernels.tdvmm import autotune_table as _table

LANE = 128
CSRC = Path(__file__).parent / "csrc"
# Columns of a readout-slot block (kSlotCols in csrc/tdvmm_tile.cuh): B2
# folds max|z| per 64-column block of its CTA tile into that block's slot,
# so a slot spans whole 64-column blocks.
TILE_N = 64
# Largest |code| a bf16 operand holds exactly (8 significant bits): the
# f32-code bf16 tile takes codes up to p = 8 (255).
BF16_EXACT_MAX = 256
# Largest |code| the 3xTF32 storage holds bitwise: p = 11 (TF32 keeps 11
# significant bits, so integers up to 2048 are exact and their lo parts 0).
TF32_EXACT_MAX = 2047
# The gate of a float32 accumulation on codes off the integer grid, the
# 3xTF32 storage's and the plain version's alike: |acc - exact| <=
# F32X3_RTOL * sum_k |x_k| |w_k| per output.  Per product the dropped lo.lo
# term and the split's residual are ~2^-22 of |x||w|; each 8-deep MMA adds
# into its stage accumulator truncating, each 32-deep stage goes into the
# total to nearest.  chip_smoke.py's noisy cases (p = 6 codes, NVIDIA H100
# 80GB HBM3 at 700 W) measure <= 9.1e-8 for the kernel and <= 2.9e-7 for
# the plain float32 GEMM; the CPU emulation of the kernel's arithmetic
# (tests/test_torch_qat.py) <= 5.7e-8 at qwen's QAT shapes.  A single TF32
# product misses the gate by ~30x.
F32X3_RTOL = 2.0 ** -20


class Tile(NamedTuple):
    """One CTA tile of B1/B2 (``Tile<>`` in csrc/tdvmm_tile.cuh)."""
    index: int          # the C entry points' ``tile`` argument
    name: str
    rows: int
    cols: int


TILES = (Tile(0, "small", 16, 64), Tile(1, "large", 128, 128))
# Most rows the small tile takes (``plan_tile``).
SMALL_TILE_MAX_ROWS = 256


def plan_tile(m: int) -> Tile:
    """The CTA tile for M rows, by M alone (the lookup's rule on a miss):
    16 x 64 while M <= 256, 128 x 128 above.  Measured on an H100
    (``scripts/tdvmm_tile_ab.py``): the small tile's many CTAs win at
    decode and at qwen's 64-row chunks and 128-row captures, the large
    tile's reuse of each staged code at the 2048-row prefills and the MoE
    dispatch buffer; between 256 and 1024 rows the winner depends on N."""
    return TILES[0] if m <= SMALL_TILE_MAX_ROWS else TILES[1]


# ---------------------------------------------------------------------------
# The per-shape tile table (storage: autotune_table.py, a generated file)
# ---------------------------------------------------------------------------
# Storage names of the table's keys: the JAX package's names for int8, int4
# and the bf16-tile float32 codes, and the 3xTF32 storage's own
DTYPE_NAMES = ("int8", "int4", "float32", "f32x3")
PLATFORMS = ("sm_90a", "plain")


def autotune_platform(device=None) -> str:
    """The platform whose launches a plan is for: "sm_90a" for codes on
    the card, "plain" for the CPU (the dry run's fake tensors too);
    without a device, the card when this process has one."""
    if device is None:
        return "sm_90a" if torch.cuda.is_available() else "plain"
    return "sm_90a" if torch.device(device).type == "cuda" else "plain"


@functools.lru_cache(maxsize=1)
def _read_table() -> dict:
    tiles = {t.name: t for t in TILES}
    out = {}
    for key, name in _table.HOPPER_TABLE.items():
        m, k, n, dtype = key
        if name not in tiles:
            raise ValueError(f"autotune table entry {key}: unknown tile "
                             f"{name!r} (tiles {sorted(tiles)})")
        if dtype not in DTYPE_NAMES or min(m, k, n) < 1:
            raise ValueError(f"autotune table key {key}: expected positive "
                             f"(M, K, N) and a storage of {DTYPE_NAMES}")
        out[key] = tiles[name]
    return out


def autotune_table(platform: Optional[str] = None) -> dict:
    """The table (M, K, N, storage name) -> ``Tile``.  Both platforms read
    the one table measured on the H100: the plain version ignores the tile,
    so a CPU run sees the card's hits.  Raises if an entry names no tile of
    ``TILES``."""
    if platform is not None and platform not in PLATFORMS:
        raise ValueError(f"platform {platform!r}, expected one of {PLATFORMS}")
    return _read_table()


def dtype_name(dtype) -> str:
    """The table's storage name for a code storage or dtype: "f32" (and a
    float32 dtype) is "float32", as the JAX package names it."""
    if isinstance(dtype, torch.dtype):
        dtype = {torch.int8: "int8", torch.float32: "float32"}.get(dtype,
                                                                    dtype)
    name = {"f32": "float32"}.get(dtype, dtype)
    if name not in DTYPE_NAMES:
        raise ValueError(f"code storage {dtype!r}, expected one of "
                         f"{DTYPE_NAMES}")
    return name


def autotune_lookup(m: int, k: int, n: int, dtype="float32",
                    platform: Optional[str] = None) -> tuple[Tile, bool]:
    """(tile, table hit) for a codes matmul of unpadded M x K x N (int4: the
    unpacked K) in storage ``dtype``; a miss takes ``plan_tile(m)``."""
    autotune_table(platform)
    return _lookup(int(m), int(k), int(n), dtype_name(dtype))


@functools.lru_cache(maxsize=4096)
def _lookup(m: int, k: int, n: int, name: str) -> tuple[Tile, bool]:
    tile = _read_table().get((m, k, n, name))
    return (plan_tile(m), False) if tile is None else (tile, True)


def autotune_blocks(m: int, k: int, n: int, dtype="float32") -> Tile:
    """The tile for a codes matmul: the table's, or ``plan_tile``'s."""
    return autotune_lookup(m, k, n, dtype)[0]


def check_code_width(codes: str, max_code: Optional[int]) -> str:
    """The kernels' storage for ``codes`` ("int8", "int4", "f32" or
    "f32x3"), or raise unless the tensor cores hold every code exactly.
    int8, int4 and f32x3 (float32 codes off the integer grid) are taken as
    they are.  Integer float32 codes ("f32") take the bf16 tile "f32" up to
    |``BF16_EXACT_MAX``| and "f32x3" up to |``TF32_EXACT_MAX``|, from
    ``max_code``, the largest |code| of either operand."""
    if codes != "f32":
        return codes
    if max_code is None:
        raise ValueError("integer float32 codes on the card need max_code "
                         "(the largest |code|) to pick an exact storage")
    if not 0 <= int(max_code) <= TF32_EXACT_MAX:
        bits = int(max_code).bit_length()
        raise ValueError(
            f"float32 codes up to |{int(max_code)}| ({bits}-bit code width) "
            f"do not fit the tensor cores exactly: the bf16 tile holds "
            f"|{BF16_EXACT_MAX}| (p <= 8), the 3xTF32 storage "
            f"|{TF32_EXACT_MAX}| (p <= 11)")
    return "f32" if int(max_code) <= BF16_EXACT_MAX else "f32x3"

def check_readout(y: torch.Tensor, acc64: torch.Tensor,
                  absacc64: torch.Tensor, x_scale: torch.Tensor,
                  w_scale: torch.Tensor, gain: float, out_bits: int,
                  s64: torch.Tensor, s_rel: torch.Tensor,
                  acc_rtol: float = F32X3_RTOL) -> tuple[int, int]:
    """Hold a readout output ``y`` (E, M, N) whose float32 accumulator lies
    within ``acc_rtol * absacc64`` of the exact ``acc64`` (float64 sums of
    the codes and of their magnitudes) to the exact readout.

    ``s64`` is the exact window, broadcastable to (E, 1, N), and ``s_rel``
    (same shape) bounds the relative error of the window ``y`` was read
    out over (0 for a fixed window; for a data-calibrated one, the
    accumulator's bound at the slot's max over the window).  Each output's
    level q (recovered from y) must lie within 0.5 + d of the exact
    c = clip(acc64 gain / s64, -1, 1) L, d the bound carried through: q is
    round(c), or its neighbour where c lies within d of a half-integer (a
    readout flip at a tie), and nothing else; and y must equal
    q xs ws s / L within the window's error and a few float32 roundings.
    Returns (flips, outputs out of the gate)."""
    levels = float((1 << out_bits) - 1)
    xs = x_scale.to(torch.float64)[..., :, None]
    ws = w_scale.to(torch.float64)[..., None, :]
    step = xs * ws * (s64 / levels)
    c = torch.clamp(acc64 * gain / s64, -1.0, 1.0) * levels
    d = levels * (acc_rtol * absacc64 * gain / s64 + s_rel) + 1e-9
    yd = y.to(torch.float64)
    q = torch.round(yd / torch.where(step == 0, 1.0, step))
    level_ok = (q - c).abs() <= 0.5 + d
    value_ok = (yd - q * step).abs() <= q.abs() * step * (s_rel + 2.0 ** -21)
    flips = int((q != torch.round(c)).sum())
    return flips, int((~(level_ok & value_ok)).sum())


# Code storages, as the kernels number them.
CODES = {"int8": 0, "int4": 1, "f32": 2, "f32x3": 3}
# Kernel launches per wrapper and code storage (a B2 call is one count for
# its two launches); int8 keeps the bare wrapper name, "f32x3" counts the
# 3xTF32 storage.
LAUNCHES = {f"{kind}{'' if codes == 'int8' else '_' + codes}": 0
            for kind in ("raw", "fused", "calibrated") for codes in CODES}
# The same launches by (M, K, N, storage name) lookup key and tile name
TILE_LAUNCHES: dict[tuple[int, int, int, str, str], int] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    TILE_LAUNCHES.clear()


def padded_size(size: int, block: int, tile: int) -> int:
    """Smallest n >= max(size, 1) with n % tile == 0 and n % min(block, n) == 0
    (the JAX package's lane rounding for grouped sites)."""
    n = ((max(size, 1) + tile - 1) // tile) * tile
    if n >= block:
        n = ((n + block - 1) // block) * block
    return n


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------
def _bind_b1(lib: ctypes.CDLL) -> None:
    vp, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.tdvmm_b1.argtypes = [vp, vp, vp, vp, vp, ll, ll, vp,
                             i, i, i, i, i, i, i, i, i, i, f, f, f, vp]
    lib.tdvmm_b1.restype = i
    lib.tdvmm_smem_bytes.argtypes = [i, i]
    lib.tdvmm_smem_bytes.restype = i


def _bind_b2(lib: ctypes.CDLL) -> None:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tdvmm_b2.argtypes = [vp, vp, vp, vp, vp, i, i, vp, vp,
                             i, i, i, i, i, i, i, i, i, f, f, f, vp]
    lib.tdvmm_b2.restype = i


# --fmad=false: the epilogue's products and sums round one by one, as the
# reference's do (bitwise contract)
LIBRARIES = {
    "b1": _build.Library("tdvmm_b1", CSRC / "tdvmm.cu", ("--fmad=false",),
                         _bind_b1),
    "b2": _build.Library("tdvmm_b2", CSRC / "tdvmm_calib.cu",
                         ("--fmad=false",), _bind_b2),
}


def _lib(name: str) -> ctypes.CDLL:
    return _build.load(LIBRARIES[name])


# ---------------------------------------------------------------------------
# Argument checks
# ---------------------------------------------------------------------------
class Launch(NamedTuple):
    """Checked geometry of one launch: K is the code depth (for int4 the
    operands hold (K + 1) // 2 packed bytes along it)."""
    e: int
    m: int
    k: int
    n: int
    shared_x: bool
    codes: str


def _check_codes(x: torch.Tensor, w: torch.Tensor,
                 int4_k: Optional[int] = None,
                 code_dtype: Optional[str] = None) -> Launch:
    """The launch geometry of x (E|1, M, K) against w (E, K, N), with the
    code storage from the dtypes: int8 x int8 (int4 pairs with ``int4_k``)
    or float32 x float32; ``code_dtype`` (the caller's plan) must agree,
    and "f32x3" takes float32 codes off the integer grid."""
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"batched codes expected: x (E|1, M, K), w (E, K, N); "
                         f"got {tuple(x.shape)} x {tuple(w.shape)}")
    if x.dtype == w.dtype == torch.int8:
        codes = "int8" if int4_k is None else "int4"
    elif x.dtype == w.dtype == torch.float32 and int4_k is None:
        codes = "f32"
    else:
        raise ValueError(
            f"TD-VMM kernels take int8 or float32 codes on both operands "
            f"(int4 pairs as int8 with int4_k), got {x.dtype} x {w.dtype}"
            + ("" if int4_k is None else f" with int4_k={int4_k}"))
    ex, m, kx = x.shape
    e, kw, n = w.shape
    k = kx if int4_k is None else int(int4_k)
    if kx != kw or ex not in (e, 1) or (
            int4_k is not None and kx != (k + 1) // 2):
        raise ValueError(f"code shapes {tuple(x.shape)} x {tuple(w.shape)}"
                         + ("" if int4_k is None else f" for int4_k={k}"))
    if x.device != w.device:
        raise ValueError(f"codes on {x.device} and {w.device}")
    if code_dtype == "f32x3" and codes == "f32":
        codes = code_dtype
    elif code_dtype not in (None, codes):
        raise ValueError(f"code storage {code_dtype!r} for {codes} codes")
    return Launch(e, m, k, n, ex == 1 and e > 1, codes)


def _count(kind: str, codes: str, key: tuple, tile: Tile) -> None:
    LAUNCHES[kind if codes == "int8" else f"{kind}_{codes}"] += 1
    key = key + (tile.name,)
    TILE_LAUNCHES[key] = TILE_LAUNCHES.get(key, 0) + 1


def _tile(g: Launch, code_dtype: Optional[str],
          tile: Optional[Tile]) -> tuple[tuple, Tile]:
    """(lookup key, tile) of a launch: the caller's storage name (its plan's
    ``code_dtype``, else the dtypes'), and the caller's tile or the
    lookup's."""
    key = (g.m, g.k, g.n, dtype_name(code_dtype or g.codes))
    if tile is None:
        tile = _lookup(*key)[0]
    elif tile not in TILES:
        raise ValueError(f"tile {tile}, expected one of {TILES}")
    return key, tile


def _check_f32(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{name}: expected float32 {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _kernel_device(x: torch.Tensor) -> bool:
    """True for a card tensor (kernel) or a fake one, False for a CPU
    tensor (plain)."""
    if hooks.card_route(x):
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"TD-VMM kernels run on cuda (or plain on cpu), got "
                     f"{x.device}")


def _contig(*ts: torch.Tensor) -> None:
    for t in ts:
        if not t.is_contiguous():
            raise ValueError("TD-VMM kernel operands must be contiguous")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _vec(t: torch.Tensor, row_bytes: int) -> int:
    """1 when the kernels may stage ``t`` by 16-byte copies: every row a
    multiple of 16 bytes and the base 16-byte aligned."""
    return int(row_bytes % 16 == 0 and t.data_ptr() % 16 == 0)


def _vecs(x: torch.Tensor, w: torch.Tensor, g: "Launch") -> tuple[int, int]:
    eb = 4 if g.codes.startswith("f32") else 1
    return _vec(x, eb * x.shape[-1]), _vec(w, eb * g.n)


def acc_dtype_for(codes: str) -> torch.dtype:
    """The raw accumulator's dtype for a code storage name: int32 for
    integer codes, else float32."""
    return torch.float32 if codes.startswith("f32") else torch.int32


def _levels(out_bits: Optional[int]) -> tuple[float, float]:
    if out_bits is None:
        return 0.0, 0.0
    levels = np.float32((1 << out_bits) - 1)
    return float(levels), float(np.float32(1.0) / levels)


# ---------------------------------------------------------------------------
# Plain versions (same arithmetic in torch ops)
# ---------------------------------------------------------------------------
def acc_plain(x: torch.Tensor, w: torch.Tensor,
              int4_k: Optional[int] = None) -> torch.Tensor:
    """Charge accumulation (E, M, N).  Integer codes (int4 pairs unpacked
    first): exact int32, as an int32 matmul on the CPU and float64 products
    and sums (exact below 2^53) on the card, a slice of experts at a time.
    Float32 codes: a float32 matmul, with TF32 off on the card (exact for
    integer codes while the sums stay below 2^24)."""
    if int4_k is not None:
        x = quant.unpack_int4(x, int4_k, axis=-1)
        w = quant.unpack_int4(w, int4_k, axis=-2)
    if x.dtype == torch.float32:
        if x.device.type == "cpu":
            return torch.matmul(x, w)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return torch.matmul(x, w)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
    if x.device.type == "cpu":
        return torch.matmul(x.to(torch.int32), w.to(torch.int32))
    # a slice of experts at a time: a whole bank's float64 copy takes 8
    # bytes a code (45 GB for one of kimi-k2's 384 x 7168 x 2048 banks)
    step = quant.expert_step(w)
    return torch.cat([torch.matmul(
        (x if x.shape[0] == 1 else x[lo:lo + step]).to(torch.float64),
        w[lo:lo + step].to(torch.float64)).to(torch.int32)
        for lo in range(0, w.shape[0], step)])


def _f32(v: float, device) -> torch.Tensor:
    return torch.full((), float(np.float32(v)), dtype=torch.float32,
                      device=device)


def epilogue_plain(acc: torch.Tensor, x_scale: torch.Tensor,
                   w_scale: torch.Tensor, gain: float,
                   out_bits: Optional[int],
                   s: Optional[torch.Tensor]) -> torch.Tensor:
    """gain -> optional p-bit readout over window ``s`` -> rescale.

    acc (E, M, N); x_scale (E|1, M); w_scale (E, N); ``s`` broadcastable to
    (E, 1, N).  The association is ``ops._epilogue``'s (and the kernels'):
    z = f32(acc) * gain, inv = 1 / s, q = round(clip(z * inv, -1, 1) * L),
    y = (q * xs) * (ws * (s * (1 / L)))."""
    dev = acc.device
    z = acc.to(torch.float32) * _f32(gain, dev)
    ws_row = w_scale[..., None, :]
    if out_bits is not None:
        levels, inv_levels = _levels(out_bits)
        inv = _f32(1.0, dev) / s
        z = torch.round(torch.clamp(z * inv, -1.0, 1.0) * _f32(levels, dev))
        ws_row = ws_row * (s * _f32(inv_levels, dev))
    return (z * x_scale[..., :, None]) * ws_row


def tdvmm_raw_plain(x: torch.Tensor, w: torch.Tensor,
                    int4_k: Optional[int] = None) -> torch.Tensor:
    _check_codes(x, w, int4_k)
    return acc_plain(x, w, int4_k)


def tdvmm_fused_plain(x, w, x_scale, w_scale, gain: float = 1.0,
                      out_bits: Optional[int] = None,
                      window: Optional[torch.Tensor] = None,
                      int4_k: Optional[int] = None) -> torch.Tensor:
    g = _check_codes(x, w, int4_k)
    s = None if out_bits is None else _window_3d(window, g.e, g.n)
    return epilogue_plain(acc_plain(x, w, int4_k), x_scale, w_scale, gain,
                          out_bits, s)


def slot_windows_plain(z: torch.Tensor, slots: torch.Tensor, nslots: int,
                       slot_bw: int) -> torch.Tensor:
    """Per-column window (E, 1, N) = max(max |z| over each column's slot,
    1e-9); slot ids come per ``slot_bw``-wide column block.  Written without
    host synchronisation (no boolean indexing), so it queues like a kernel."""
    e, m, n = z.shape
    col = slots.repeat_interleave(slot_bw, dim=1)[:, :n]          # (E, N)
    colmax = torch.amax(torch.abs(z), dim=1) if m else torch.zeros_like(
        col, dtype=torch.float32)
    smax = torch.stack([torch.amax(torch.where(col == sid, colmax, 0.0))
                        for sid in range(nslots)])
    smax = torch.maximum(smax, _f32(1e-9, z.device))
    return smax[col.long()].reshape(e, 1, n)


def tdvmm_calibrated_plain(x, w, x_scale, w_scale, slots: torch.Tensor,
                           nslots: int, slot_bw: int, gain: float = 1.0,
                           out_bits: int = 6,
                           int4_k: Optional[int] = None) -> torch.Tensor:
    _check_codes(x, w, int4_k)
    acc = acc_plain(x, w, int4_k)
    z = acc.to(torch.float32) * _f32(gain, acc.device)
    s = slot_windows_plain(z, slots, nslots, slot_bw)
    return epilogue_plain(acc, x_scale, w_scale, gain, out_bits, s)


def _window_3d(window: Optional[torch.Tensor], e: int, n: int) -> torch.Tensor:
    """A readout window of shape (), (E,), (E, 1, 1) or (E, 1, N) as an
    (E|1, 1, N|1) view broadcastable to (E, 1, N)."""
    if window is None:
        raise ValueError("a fixed readout window is needed for out_bits")
    if window.dtype != torch.float32:
        raise ValueError(f"window must be float32, got {window.dtype}")
    if window.dim() == 0:
        return window.reshape(1, 1, 1)
    if window.dim() == 1 and window.shape[0] == e:
        return window.reshape(e, 1, 1)
    if window.dim() == 3 and window.shape[0] in (1, e) \
            and window.shape[1] == 1 and window.shape[2] in (1, n):
        return window
    raise ValueError(f"window shape {tuple(window.shape)} for E={e}, N={n}")


# ---------------------------------------------------------------------------
# Wrappers (kernel on the card, plain version on the CPU)
# ---------------------------------------------------------------------------
def _storage(x: torch.Tensor, int4_k, max_code, code_dtype) -> str:
    """The code storage a call takes, as ``check_code_width`` picks it on
    the card, without its checks (for the counting hook)."""
    if x.dtype == torch.int8:
        return "int8" if int4_k is None else "int4"
    if code_dtype == "f32x3" or (max_code is not None
                                 and max_code > BF16_EXACT_MAX):
        return "f32x3"
    return "f32"


def _hooked(kind: str, impl, x, w, int4_k, max_code, code_dtype,
            readout: bool, *args):
    """``impl(x, w, *args)`` inside ``hooks.call`` with its geometry
    (``readout``: a p-bit readout with its window)."""
    if hooks.HOOK is None:
        return impl(x, w, *args)
    codes = _storage(x, int4_k, max_code, code_dtype)
    with hooks.call(kind if codes == "int8" else f"{kind}_{codes}",
                    e=w.shape[0], ex=x.shape[0], m=x.shape[1],
                    k=x.shape[2] if int4_k is None else int(int4_k),
                    n=w.shape[2], codes=codes, scales=kind != "raw",
                    readout=readout):
        return impl(x, w, *args)


def tdvmm_matmul_raw(x: torch.Tensor, w: torch.Tensor,
                     int4_k: Optional[int] = None,
                     max_code: Optional[int] = None,
                     code_dtype: Optional[str] = None,
                     tile: Optional[Tile] = None) -> torch.Tensor:
    """B1 raw mode (``_matmul_raw``)."""
    return _hooked("raw", _matmul_raw, x, w, int4_k, max_code, code_dtype,
                   False, int4_k, max_code, code_dtype, tile)


def _matmul_raw(x: torch.Tensor, w: torch.Tensor,
                int4_k: Optional[int] = None,
                max_code: Optional[int] = None,
                code_dtype: Optional[str] = None,
                tile: Optional[Tile] = None) -> torch.Tensor:
    """B1 raw mode: (E, M, N) charge accumulation, int32 for integer codes,
    float32 for float32 codes.  ``max_code``: the largest |code| of either
    operand, for integer float32 codes; ``code_dtype``: the caller's code
    storage ("f32x3" for float32 codes off the integer grid), else taken
    from the dtypes (``check_code_width`` picks the storage from both);
    ``tile``: the CTA tile its caller planned, else ``autotune_lookup``'s."""
    if not _kernel_device(x):
        return tdvmm_raw_plain(x, w, int4_k)
    g = _check_codes(x, w, int4_k, code_dtype)
    codes = check_code_width(g.codes, max_code)
    key, tile = _tile(g, code_dtype, tile)
    _contig(x, w)
    out = torch.empty((g.e, g.m, g.n), dtype=acc_dtype_for(g.codes),
                      device=x.device)
    if out.numel() == 0 or hooks.is_fake(x):
        return out
    err = _lib("b1").tdvmm_b1(
        x.data_ptr(), w.data_ptr(), None, None, None, 0, 0, out.data_ptr(),
        g.e, g.m, g.k, g.n, int(g.shared_x), *_vecs(x, w, g), 0,
        CODES[codes], tile.index, 1.0, 0.0, 0.0, _stream())
    _build.check_launch(err, "tdvmm_matmul_raw")
    _count("raw", codes, key, tile)
    return out


def tdvmm_fused(x: torch.Tensor, w: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor, gain: float = 1.0,
                out_bits: Optional[int] = None,
                window: Optional[torch.Tensor] = None,
                int4_k: Optional[int] = None,
                max_code: Optional[int] = None,
                code_dtype: Optional[str] = None,
                tile: Optional[Tile] = None) -> torch.Tensor:
    """B1 fused (``_fused``)."""
    return _hooked("fused", _fused, x, w, int4_k, max_code, code_dtype,
                   out_bits is not None, x_scale, w_scale, gain, out_bits,
                   window, int4_k, max_code, code_dtype, tile)


def _fused(x: torch.Tensor, w: torch.Tensor, x_scale: torch.Tensor,
           w_scale: torch.Tensor, gain: float = 1.0,
           out_bits: Optional[int] = None,
           window: Optional[torch.Tensor] = None,
           int4_k: Optional[int] = None,
           max_code: Optional[int] = None,
           code_dtype: Optional[str] = None,
           tile: Optional[Tile] = None) -> torch.Tensor:
    """B1 fused: integrate + gain -> optional readout over a fixed window
    -> per-row x per-column rescale, float32 (E, M, N) out.

    x_scale (E|1, M), w_scale (E, N) float32; ``window`` (with ``out_bits``)
    is (), (E,), (E, 1, 1) or (E, 1, N) float32; ``max_code``,
    ``code_dtype`` and ``tile`` as for ``tdvmm_matmul_raw``."""
    if not _kernel_device(x):
        return tdvmm_fused_plain(x, w, x_scale, w_scale, gain, out_bits,
                                 window, int4_k)
    g = _check_codes(x, w, int4_k, code_dtype)
    codes = check_code_width(g.codes, max_code)
    key, tile = _tile(g, code_dtype, tile)
    e, m, n = g.e, g.m, g.n
    _check_f32("x_scale", x_scale, (x.shape[0], m), x.device)
    _check_f32("w_scale", w_scale, (e, n), x.device)
    mode, win, se, sn = 1, None, 0, 0
    if out_bits is not None:
        win = _window_3d(window, e, n)
        _check_f32("window", win, tuple(win.shape), x.device)
        mode = 2
        se = win.stride(0) if win.shape[0] > 1 else 0
        sn = win.stride(2) if win.shape[2] > 1 else 0
    _contig(x, w, x_scale, w_scale)
    out = torch.empty((e, m, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0 or hooks.is_fake(x):
        return out
    levels, inv_levels = _levels(out_bits)
    err = _lib("b1").tdvmm_b1(
        x.data_ptr(), w.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(),
        None if win is None else win.data_ptr(), se, sn, out.data_ptr(),
        e, m, g.k, n, int(g.shared_x), *_vecs(x, w, g), mode,
        CODES[codes], tile.index, float(np.float32(gain)), levels,
        inv_levels, _stream())
    _build.check_launch(err, "tdvmm_fused")
    _count("fused", codes, key, tile)
    return out


def tdvmm_calibrated(x: torch.Tensor, w: torch.Tensor, x_scale: torch.Tensor,
                     w_scale: torch.Tensor, slots: torch.Tensor, nslots: int,
                     slot_bw: int, gain: float = 1.0,
                     out_bits: int = 6,
                     int4_k: Optional[int] = None,
                     max_code: Optional[int] = None,
                     code_dtype: Optional[str] = None,
                     tile: Optional[Tile] = None) -> torch.Tensor:
    """B2 (``_calibrated``)."""
    return _hooked("calibrated", _calibrated, x, w, int4_k, max_code,
                   code_dtype, True, x_scale, w_scale, slots, nslots,
                   slot_bw, gain, out_bits, int4_k, max_code, code_dtype,
                   tile)


def _calibrated(x: torch.Tensor, w: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor, slots: torch.Tensor, nslots: int,
                slot_bw: int, gain: float = 1.0,
                out_bits: int = 6,
                int4_k: Optional[int] = None,
                max_code: Optional[int] = None,
                code_dtype: Optional[str] = None,
                tile: Optional[Tile] = None) -> torch.Tensor:
    """B2: integrate + data-calibrated readout, float32 (E, M, N) out.

    ``slots`` (E, ceil(N / slot_bw)) int32 is the readout-slot id of every
    ``slot_bw``-wide column block (``ops._calib_slots``); each slot's window
    is max(max|z| over its columns, 1e-9).  ``max_code``, ``code_dtype``
    and ``tile`` as for ``tdvmm_matmul_raw``."""
    if not _kernel_device(x):
        return tdvmm_calibrated_plain(x, w, x_scale, w_scale, slots, nslots,
                                      slot_bw, gain, out_bits, int4_k)
    g = _check_codes(x, w, int4_k, code_dtype)
    codes = check_code_width(g.codes, max_code)
    key, tile = _tile(g, code_dtype, tile)
    e, m, n = g.e, g.m, g.n
    _check_f32("x_scale", x_scale, (x.shape[0], m), x.device)
    _check_f32("w_scale", w_scale, (e, n), x.device)
    nsb = -(-n // slot_bw)
    if slots.dtype != torch.int32 or tuple(slots.shape) != (e, nsb) \
            or slots.device != x.device:
        raise ValueError(f"slots: expected int32 ({e}, {nsb}) on {x.device}")
    if nsb > 1 and slot_bw % TILE_N:
        raise ValueError(f"slot block width {slot_bw} must be a multiple of "
                         f"the kernel's {TILE_N}-column tile")
    _contig(x, w, x_scale, w_scale, slots)
    out = torch.empty((e, m, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0 or hooks.is_fake(x):
        return out
    slot_max = torch.zeros(nslots, dtype=torch.float32, device=x.device)
    levels, inv_levels = _levels(out_bits)
    err = _lib("b2").tdvmm_b2(
        x.data_ptr(), w.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(),
        slots.data_ptr(), nsb, slot_bw, slot_max.data_ptr(), out.data_ptr(),
        e, m, g.k, n, int(g.shared_x), *_vecs(x, w, g), CODES[codes],
        tile.index, float(np.float32(gain)), levels, inv_levels,
        _stream())
    _build.check_launch(err, "tdvmm_calibrated")
    _count("calibrated", codes, key, tile)
    return out
