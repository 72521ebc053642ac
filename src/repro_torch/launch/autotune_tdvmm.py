"""Measure the TD-VMM kernels' CTA tile per launch shape on the card and
regenerate ``kernels/tdvmm/autotune_table.py``.

    python -m repro_torch.launch.autotune_tdvmm            # every arch, M 512
    python -m repro_torch.launch.autotune_tdvmm --archs qwen1.5-0.5b
    python -m repro_torch.launch.autotune_tdvmm --dry-run  # print, write nothing

The work list (``collect_shapes``): the JAX package's benchmark shapes
(``BENCH_SHAPES``, from its ``scripts/autotune_tdvmm.py``), every arch's
``configs.plan.plan_launch_shapes(cfg, M)``, and qwen1.5-0.5b's ffn sites
at full width at the rows of chip_smoke.py's engine phases
(``serving_shapes``), each in the storage its plan gives it.  Keys are the
table's: unpadded (M, K, N, storage name), int4 with the unpacked K.

For each shape (``sweep``), on operands drawn from a seed: B1 raw, B1 fused
with a scalar readout window and B2 at every tile of ``tdvmm.TILES``, each
bitwise equal to the first tile's and, up to ``PLAIN_LIMIT`` operations,
to the plain version; a tile that differs stops the sweep.  Then B1 fused
with the scalar window, the JAX package's timed mode, is timed at each tile
(``time_ms``) in ``ROUNDS`` interleaved rounds.  The tile with the least
median is written, unless ``plan_tile``'s lies within the rounds' spread of
it: then ``plan_tile``'s is kept, so the table does not follow noise.
Shapes of more than ``--measure-limit`` operations are not timed and get no
entry (``plan_tile`` takes them).  ``render`` writes the same text for the
same entries; a run keeps the committed entries it did not measure.

Needs one CUDA card and raises without one; ``collect_shapes`` and
``render`` run anywhere.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
from pathlib import Path

import torch

TABLE_PATH = (Path(__file__).resolve().parents[1] / "kernels" / "tdvmm"
              / "autotune_table.py")

# The JAX package's BENCH_SHAPES (its scripts/autotune_tdvmm.py): the shapes
# its benchmarks and the perceptron case study launch
BENCH_SHAPES: list[tuple[int, int, int, str]] = [
    (512, 1024, 4096, "float32"),
    (512, 1024, 4096, "int8"),
    (512, 1024, 4096, "int4"),
    (256, 896, 896, "float32"),
    (33, 300, 130, "float32"),
    (512, 2048, 512, "float32"),
    (512, 2048, 512, "int8"),
    (512, 2048, 512, "int4"),
    (256, 1024, 4096, "int8"),
    (256, 1024, 512, "int8"),
    (64, 896, 1152, "int8"),
    (64, 512, 2432, "int8"),
    (8, 128, 64, "float32"),
    (8, 128, 64, "int8"),
]
# qwen1.5-0.5b's ffn sites as chip_smoke.py's engine phases serve them: the
# rows of a decode step (4 slots), a prefill chunk (64), the calibration
# capture (2 x 64) and the drift probe (2 x 128)
SERVING_ARCH = "qwen1.5-0.5b"
SERVING_SITES = ("ffn.in", "ffn.out")
SERVING_ROWS = (4, 64, 128, 256)
# |code| limits (x, w) per storage: p = 6 codes; p = 8 inputs x 4-bit
# weights (float32 codes on the bf16 tile); 3-bit x 3-bit (int4 pairs)
CODE_LIMITS = {"int8": (63, 63), "float32": (255, 15), "int4": (7, 7)}
STORAGE = {"int8": "int8", "int4": "int4", "float32": "f32"}
# operations up to which each tile is also held to the plain version (a
# card's plain product of integer codes runs in float64)
PLAIN_LIMIT = 2e11
ROUNDS = 5
OUT_BITS, WINDOW = 6, 0.5


def time_ms(fn, iters: int = 20) -> float:
    """Device milliseconds of one call: CUDA events around ``iters`` calls
    queued behind a device sleep, so no host gap is in the time."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    cycles = 50_000_000
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise RuntimeError("the timed calls could not be queued ahead of the card")


def serving_shapes() -> list[tuple[int, int, int, str]]:
    from repro_torch.configs import archs, plan
    cfg = archs.get_config(SERVING_ARCH)
    sites = plan.site_linear_shapes(cfg)
    mats = {kn for s in SERVING_SITES for kn in sites[s]["matrices"]}
    return [s for m in SERVING_ROWS for s in plan.plan_launch_shapes(cfg, m)
            if s[1:3] in mats]


def collect_shapes(arch_names, m: int) -> list[tuple[int, int, int, str]]:
    """The work list, deduplicated in order, keyed by storage name."""
    from repro_torch.configs import archs, plan
    from repro_torch.kernels.tdvmm import tdvmm
    shapes = list(BENCH_SHAPES)
    for a in arch_names:
        shapes += plan.plan_launch_shapes(archs.get_config(a), m)
    shapes += serving_shapes()
    return list(dict.fromkeys(
        (mm, k, n, tdvmm.dtype_name(d)) for mm, k, n, d in shapes))


def operands(m: int, k: int, n: int, name: str, dev, seed: int) -> dict:
    """Codes (int4 packed), scales, window and B2's one slot of a shape."""
    from repro_torch.core import quant
    from repro_torch.kernels.tdvmm import ops, tdvmm
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    lx, lw = CODE_LIMITS[name]
    dtype = torch.float32 if name == "float32" else torch.int8
    x = torch.randint(-lx, lx + 1, (1, m, k), generator=g, device=dev,
                      dtype=dtype)
    w = torch.randint(-lw, lw + 1, (1, k, n), generator=g, device=dev,
                      dtype=dtype)
    int4_k = None
    if name == "int4":
        x = quant.pack_int4(x, axis=-1).contiguous()
        w = quant.pack_int4(w, axis=-2).contiguous()
        int4_k = k
    slots, nslots = ops._calib_slots(1, n, tdvmm.TILE_N, None)
    return dict(x=x, w=w, xs=torch.rand((1, m), generator=g, device=dev) + 0.5,
                ws=torch.rand((1, n), generator=g, device=dev) + 0.5,
                gain=1.0 / (float(lx) * float(lw) * 2.0 * k),
                window=torch.full((), WINDOW, device=dev), int4_k=int4_k,
                max_code=max(lx, lw), code_dtype=STORAGE[name],
                slots=slots.to(dev), nslots=nslots)


def calls(o: dict) -> dict:
    """kind -> (kernel at a tile, plain version) on operands ``o``."""
    from repro_torch.kernels.tdvmm import tdvmm as tk
    x, w, i4, mc, cd = (o[f] for f in ("x", "w", "int4_k", "max_code",
                                       "code_dtype"))
    args = (x, w, o["xs"], o["ws"])
    b2 = (o["slots"], o["nslots"], tk.TILE_N, o["gain"], OUT_BITS)
    return {
        "raw": (lambda t: tk.tdvmm_matmul_raw(x, w, i4, mc, cd, t),
                lambda: tk.tdvmm_raw_plain(x, w, i4)),
        "fused": (lambda t: tk.tdvmm_fused(*args, o["gain"], OUT_BITS,
                                           o["window"], i4, mc, cd, t),
                  lambda: tk.tdvmm_fused_plain(*args, o["gain"], OUT_BITS,
                                               o["window"], i4)),
        "calibrated": (lambda t: tk.tdvmm_calibrated(*args, *b2, i4, mc, cd,
                                                     t),
                       lambda: tk.tdvmm_calibrated_plain(*args, *b2, i4)),
    }


def check_tiles(key, o: dict) -> None:
    """Every tile's output bitwise the first tile's, and the plain
    version's up to ``PLAIN_LIMIT`` operations; raises on a difference."""
    from repro_torch.kernels.tdvmm import tdvmm as tk
    m, k, n, _ = key
    for kind, (kern, plain) in calls(o).items():
        ref = plain() if 2.0 * m * k * n <= PLAIN_LIMIT else None
        first = None
        for tile in tk.TILES:
            y = kern(tile)
            if first is None:
                first = y
            elif not torch.equal(y, first):
                raise RuntimeError(f"{key} {kind}: tile {tile.name} differs "
                                   f"from tile {tk.TILES[0].name}")
            if ref is not None and not torch.equal(y, ref):
                raise RuntimeError(f"{key} {kind}: tile {tile.name} differs "
                                   "from the plain version")
        del first, ref


def measure(key, o: dict, rounds: int = ROUNDS) -> dict:
    """B1 fused with the scalar window at each tile, ``rounds`` interleaved
    rounds: the times, their medians, the spread (the largest max - min of
    a tile's rounds), the pick and ``plan_tile``'s tile."""
    from repro_torch.kernels.tdvmm import tdvmm as tk
    m, k, n, _ = key
    fused = calls(o)["fused"][0]
    iters = int(min(100, max(5, 2e11 / (2.0 * m * k * n))))
    times = {t.name: [] for t in tk.TILES}
    for r in range(rounds):
        for tile in (tk.TILES if r % 2 == 0 else tk.TILES[::-1]):
            times[tile.name].append(time_ms(lambda: fused(tile), iters))
    med = {t: statistics.median(v) for t, v in times.items()}
    spread = max(max(v) - min(v) for v in times.values())
    planned = tk.plan_tile(m).name
    best = min(med, key=med.get)
    noise = best != planned and med[planned] - med[best] <= spread
    return dict(key=key, times=times, median=med, spread=spread,
                pick=planned if noise else best, planned=planned,
                within_spread=noise)


def f32x3_tiles_equal(key, dev, seed: int) -> bool:
    """Whether B1 fused (no readout) and raw give one tile's bits at every
    tile on float32 codes off the integer grid (the 3xTF32 storage)."""
    from repro_torch.kernels.tdvmm import tdvmm as tk
    m, k, n, _ = key
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randint(-63, 64, (1, m, k), generator=g, device=dev).float()
    w = torch.randint(-63, 64, (1, k, n), generator=g, device=dev).float()
    w = w * (1.0 + 0.05 * torch.randn(w.shape, generator=g, device=dev))
    xs, ws = torch.ones((1, m), device=dev), torch.ones((1, n), device=dev)
    outs = [(tk.tdvmm_matmul_raw(x, w, code_dtype="f32x3", tile=t),
             tk.tdvmm_fused(x, w, xs, ws, code_dtype="f32x3", tile=t))
            for t in tk.TILES]
    return all(torch.equal(a, b) for o in outs[1:]
               for a, b in zip(o, outs[0]))


def sweep(shapes, measure_limit: float, seed: int = 0, log=print) -> list:
    """Check and time every shape (see the module's docstring); one row
    per shape, ``None`` times above ``measure_limit``."""
    if not torch.cuda.is_available():
        raise RuntimeError("autotune_tdvmm measures the kernels on a CUDA "
                           "card: no CUDA device is available")
    dev = torch.device("cuda")
    rows = []
    for i, key in enumerate(shapes):
        m, k, n, name = key
        if 2.0 * m * k * n > measure_limit:
            rows.append(dict(key=key, pick=None))
            log(f"[autotune] {m}x{k}x{n}:{name} not timed (over "
                f"--measure-limit {measure_limit:g})")
            continue
        o = operands(m, k, n, name, dev, seed + i)
        check_tiles(key, o)
        row = measure(key, o)
        if name == "float32":
            row["f32x3_equal"] = f32x3_tiles_equal(key, dev, seed + i)
        del o
        rows.append(row)
        log(f"[autotune] {m}x{k}x{n}:{name} " + " ".join(
            f"{t}={row['median'][t]:.5f}" for t in row["median"])
            + f" ms spread={row['spread']:.5f} pick={row['pick']} "
            f"plan_tile={row['planned']}"
            + (" (within spread)" if row["within_spread"] else "")
            + ("" if "f32x3_equal" not in row else
               f" f32x3 tiles bitwise={row['f32x3_equal']}"))
    return rows


def current_entries() -> dict:
    from repro_torch.kernels.tdvmm import autotune_table
    return dict(autotune_table.HOPPER_TABLE)


def measured_entries(rows) -> dict:
    return {r["key"]: r["pick"] for r in rows if r["pick"] is not None}


HEADER = '''"""The TD-VMM kernels' CTA tile per launch shape (GENERATED FILE).

Measured on an NVIDIA H100 and written by ``python -m
repro_torch.launch.autotune_tdvmm``, which times B1 fused at every tile of
``tdvmm.TILES`` after checking every tile bitwise; hand edits last until
its next run.  ``tdvmm.autotune_lookup`` reads it on the card and on the
CPU alike (the plain version ignores the tile); a miss takes
``tdvmm.plan_tile``.

Keys are the unpadded (M, K, N, storage name) of a codes matmul, int4 with
the unpacked K, grouped launches with their lane-rounded concat width;
storage names are "int8", "int4", "float32" (float32 codes on the bf16
tile) and "f32x3" (the 3xTF32 storage).  Values name a tile of
``tdvmm.TILES``.
"""

# fmt: off
'''


def render(entries: dict) -> str:
    """The table module's text for ``entries`` {(M, K, N, name): tile}."""
    lines = [f'    ({m}, {k}, {n}, "{name}"): "{tile}",'
             for (m, k, n, name), tile in sorted(entries.items())]
    return (HEADER + "HOPPER_TABLE: dict[tuple[int, int, int, str], str] = {\n"
            + "".join(ln + "\n" for ln in lines) + "}\n# fmt: on\n")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    return out.splitlines()[0] if out else "not read"


def summary(rows) -> list[str]:
    """The run's summary lines: shapes timed, where the pick differs from
    ``plan_tile``'s (with both times), the spread, the f32x3 finding."""
    timed = [r for r in rows if r["pick"] is not None]
    flips = [r for r in timed if r["pick"] != r["planned"]]
    rel = sorted(r["spread"] / min(r["median"].values()) for r in timed)
    out = [f"[autotune] {len(rows)} shapes, {len(timed)} timed, "
           f"{len(flips)} where the pick differs from plan_tile, "
           f"{sum(r['within_spread'] for r in timed)} kept at plan_tile "
           "within the spread"]
    if rel:
        out.append(f"[autotune] spread of the rounds over the least median: "
                   f"median {statistics.median(rel):.4f}, max {rel[-1]:.4f}")
    for r in flips:
        m, k, n, name = r["key"]
        out.append(f"[autotune] differs: {m}x{k}x{n}:{name} {r['pick']} "
                   f"{r['median'][r['pick']]:.5f} ms, plan_tile "
                   f"{r['planned']} {r['median'][r['planned']]:.5f} ms")
    f3 = [r["f32x3_equal"] for r in timed if "f32x3_equal" in r]
    if f3:
        out.append(f"[autotune] f32x3: tiles bitwise at {sum(f3)} of "
                   f"{len(f3)} float32 shapes")
    return out


def main(argv=None) -> int:
    from repro_torch.configs import archs
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", nargs="*", default=sorted(archs.ARCHS),
                    help="archs whose plan_launch_shapes to tune (default: "
                         "all)")
    ap.add_argument("--m", type=int, default=512,
                    help="rows M of the archs' launch shapes")
    ap.add_argument("--measure-limit", type=float, default=1e13,
                    help="most 2*M*K*N operations to time; larger shapes "
                         "get no entry")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the table instead of writing it")
    args = ap.parse_args(argv)
    shapes = collect_shapes(args.archs, args.m)
    print(f"[autotune] {len(shapes)} shapes", flush=True)
    rows = sweep(shapes, args.measure_limit,
                 log=lambda s: print(s, flush=True))
    for line in summary(rows):
        print(line)
    print(f"[autotune] {card_line()}")
    text = render({**current_entries(), **measured_entries(rows)})
    if args.dry_run:
        print(text)
        return 0
    TABLE_PATH.write_text(text)
    print(f"[autotune] wrote {TABLE_PATH}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
