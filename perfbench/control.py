"""The readings that the limits of ``correct`` are set from, on the card:
for each seed, a short window of the cell's timed path, then the compared
numbers of the program and of the control (the plain reference computed
in float8 in the program's place, at the same prompts and positions).

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 5 [--out control.jsonl]

The benchmark's own runs never run the control.  One line of JSON per
seed: {"seed", "program": {...}, "control": {...}}.
"""
import json
import sys
import time
from pathlib import Path


def main() -> None:
    import argparse
    import contextlib
    import gc

    import torch
    from perfbench import harness
    harness.cache_env(Path.cwd())
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    with (open(args.out, "a") if args.out
          else contextlib.nullcontext()) as out:
        for seed in (int(s) for s in args.seeds.split(",")):
            gc.collect()
            torch.cuda.empty_cache()
            res = harness.run_cell(args.workload, seed, args.seconds, False,
                                   time.time(), control=True)
            ref = res["reference"]
            line = json.dumps({
                "seed": seed, "program": ref.pop("readings"),
                "control": ref.pop("control"),
                "attempted": res["attempted"], "reference": ref,
                "setup_s": res["metrics"].get("setup_s", {}).get("value")})
            print(line, flush=True)
            if out is not None:
                out.write(line + "\n")
                out.flush()


if __name__ == "__main__":
    sys.path[:0] = [str(Path.cwd()), str(Path.cwd() / "src")]
    main()
