"""A/B of the TD-VMM kernels' CTA tiles on the card.

Times B1 (raw and fused with a scalar readout window) and B2 (one readout
slot) at every CTA tile of ``repro_torch.kernels.tdvmm.tdvmm.TILES``, forced
in turn, at the serving shapes whose row count sits near a tile boundary:
qwen1.5-0.5b's ffn.in / ffn.out (decode 4 rows, prefill chunks of 64, the
calibration captures of 128), mamba2-1.3b's ssm.in_proj / ssm.out (4 rows
at decode, 2048 at prefill) and mixtral-8x7b's expert grid (E 8, 5 and
2049 rows).  Each forced tile is first checked bitwise against the plain
version, then timed with CUDA events around calls queued while the card
slept.

    python3 scripts/tdvmm_tile_ab.py [--out tile_ab.json]

Prints one line per (shape, storage, kernel, M) with the milliseconds of each
tile, the tile ``plan_tile`` picks and the autotune table's
(``tdvmm.autotune_lookup``), then the card's name and power limit;
``--out`` also writes the rows as JSON.
Needs one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {                                    # name: (E, K, N)
    "qwen ffn.in": (1, 1024, 2816),
    "qwen ffn.out": (1, 2816, 1024),
    "mamba2 ssm.in_proj": (1, 2048, 8576),
    "mamba2 ssm.out": (1, 4096, 2048),
    "mixtral w1": (8, 4096, 14336),
    "mixtral w2": (8, 14336, 4096),
}
ROWS = (4, 16, 17, 32, 64, 128, 129, 256, 512, 1024, 2048)
SMALL_ROWS = (4, 16, 17, 32, 64, 128, 129, 256)
DENSE = ("qwen ffn.in", "qwen ffn.out", "mamba2 ssm.in_proj", "mamba2 ssm.out")
# (storage, shapes, rows): int8 at every dense shape, the other storages at
# qwen ffn.in, and mixtral's expert grid at decode (5) and prefill (2049)
# rows in the storage each of its plans gives it
RUNS = [("int8", DENSE, ROWS), ("f32", ("qwen ffn.in",), SMALL_ROWS),
        ("int4", ("qwen ffn.in",), SMALL_ROWS),
        ("int8", ("mixtral w1",), (5, 2049)),
        ("f32", ("mixtral w1",), (5, 2049)),
        ("int4", ("mixtral w2",), (5, 2049))]
LIMITS = {"int8": (63, 63), "f32": (255, 15), "int4": (7, 7)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the rows as JSON to this file")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.core import quant
    from repro_torch.kernels.tdvmm import ops, tdvmm as tk
    from repro_torch.launch.autotune_tdvmm import time_ms

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows_out = []
    for codes, shapes, rows in RUNS:
        lim_x, lim_w = LIMITS[codes]
        dtype = torch.float32 if codes == "f32" else torch.int8
        for shape in shapes:
            e, k, n = SHAPES[shape]
            for m in rows:
                g = torch.Generator(device=dev)
                g.manual_seed(args.seed)
                x = torch.randint(-lim_x, lim_x + 1, (e, m, k), generator=g,
                                  device=dev, dtype=dtype)
                w = torch.randint(-lim_w, lim_w + 1, (e, k, n), generator=g,
                                  device=dev, dtype=dtype)
                xs = torch.rand((e, m), generator=g, device=dev) + 0.5
                ws = torch.rand((e, n), generator=g, device=dev) + 0.5
                gain = 1.0 / (float(lim_x) * float(lim_w) * 2.0 * k)
                i4 = None
                if codes == "int4":
                    x = quant.pack_int4(x, axis=-1).contiguous()
                    w = quant.pack_int4(w, axis=-2).contiguous()
                    i4 = k
                mc = max(lim_x, lim_w)
                window = torch.full((), 0.5, device=dev)
                slots, nslots = ops._calib_slots(e, n, tk.TILE_N, None)
                slots = slots.contiguous().to(dev)
                calls = {
                    "raw": (lambda t: tk.tdvmm_matmul_raw(
                                x, w, i4, mc, tile=t),
                            lambda: tk.tdvmm_raw_plain(x, w, i4)),
                    "fused": (lambda t: tk.tdvmm_fused(
                                  x, w, xs, ws, gain, 6, window, i4, mc,
                                  tile=t),
                              lambda: tk.tdvmm_fused_plain(
                                  x, w, xs, ws, gain, 6, window, i4)),
                    "calibrated": (lambda t: tk.tdvmm_calibrated(
                                       x, w, xs, ws, slots, nslots,
                                       tk.TILE_N, gain, 6, i4, mc, tile=t),
                                   lambda: tk.tdvmm_calibrated_plain(
                                       x, w, xs, ws, slots, nslots,
                                       tk.TILE_N, gain, 6, i4)),
                }
                iters = 3 if e * m * k * n > 1e11 else 20
                for kind, (kern, plain) in calls.items():
                    ref = plain()
                    ms = {}
                    for tile in tk.TILES:
                        y = kern(tile)
                        same = torch.equal(y, ref)
                        del y
                        if not same:
                            raise RuntimeError(
                                f"{shape} {codes} {kind} M={m}: tile "
                                f"{tile.name} differs from plain")
                        ms[tile.name] = time_ms(lambda: kern(tile), iters)
                    del ref
                    best = min(ms, key=ms.get)
                    row = dict(shape=shape, codes=codes, kernel=kind, e=e,
                               m=m, k=k, n=n, ms=ms, best=best,
                               planned=tk.plan_tile(m).name,
                               table=tk.autotune_blocks(m, k, n, codes).name)
                    rows_out.append(row)
                    print(f"[tile_ab] {shape:18s} {codes:4s} {kind:10s} "
                          f"E={e} M={m:<4d} " + " ".join(
                              f"{t}={v:.5f}" for t, v in ms.items())
                          + f" best={best} planned={row['planned']} "
                          f"table={row['table']}", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    card = card.strip().splitlines()[0] if card.strip() else "not read"
    print(card)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "rows": rows_out}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
