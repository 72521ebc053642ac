"""Seconds a step of the paged engine, one source tree against another, on
the card.

    python3 scripts/engine_host_ab.py OTHER_TREE

Each tree (A: this repository, B: ``OTHER_TREE``, a checkout of another
commit) serves ``chip_smoke.py``'s qwen1.5-0.5b trace (full width, its
``SERVE_LAYERS`` layers, the ``ffn_unchained`` plan, random weights from
seed 0, calibrated once) through that tree's own ``Engine``, in a
subprocess of its own, ``REPEATS`` times after one warm-up run; the trees
take turns in ``ORDER``.  The qwen engine is host-bound (its steps a few percent
device-busy), so this compares the host time each tree's Python adds to a
step.  Prints one line per turn (every run's seconds a step, their median,
the launches) and the card's name and power limit.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ORDER, REPEATS = "BAAB", 5

TURN = r"""
import json, sys
sys.path[:0] = [{root!r}, {root!r} + "/src"]
import torch
import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.kernels.tdvmm import tdvmm as tk
from repro_torch.models import model
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.paged_cache import pages_for
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
cfg = get_config(cs.ARCH).replace(n_layers=cs.SERVE_LAYERS,
                                  tdvmm_plan=cs.plans()["ffn_unchained"])
params = model.init_params(0, cfg, device=dev)
trace = cs.make_trace(cfg.vocab_size)
max_len = max(len(r.prompt) + r.max_new_tokens for r in trace)
ecfg = EngineConfig(slots=cs.SLOTS, page_size=cs.PAGE,
                    num_pages=cs.NUM_PAGES, chunk=cs.CHUNK,
                    max_pages_per_slot=pages_for(max_len, cs.PAGE))
g = torch.Generator(device=dev)
g.manual_seed(1)
tokens = torch.randint(0, cfg.vocab_size, cs.CALIB_BATCH, generator=g,
                       device=dev)
calib = model.calibrate(params, {{"inputs": tokens}}, cfg)
Engine(cfg, params, ecfg, calib=calib).run(trace)          # warm-up
per_step, streams = [], None
tk.reset_launches()
for _ in range({repeats}):
    torch.cuda.synchronize()
    rep = Engine(cfg, params, ecfg, calib=calib).run(trace)
    torch.cuda.synchronize()
    per_step.append(rep.wall_s / rep.steps)
    streams = [r["tokens"] for r in rep.requests]
print(json.dumps(dict(per_step=per_step, steps=rep.steps,
                      launches=dict(tk.LAUNCHES)["fused"],
                      streams=streams)))
"""


def turn(root: Path, repeats: int) -> dict:
    out = subprocess.run([sys.executable, "-c",
                          TURN.format(root=str(root), repeats=repeats)],
                         capture_output=True, text=True, cwd=root)
    if out.returncode:
        raise RuntimeError(f"{root}: exit {out.returncode}\n{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="the other tree (B)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("engine_host_ab: no CUDA device is available", file=sys.stderr)
        return 2
    trees = {"A": ROOT, "B": args.other.resolve()}
    streams = {}
    for name in ORDER:
        r = turn(trees[name], REPEATS)
        streams.setdefault(name, r["streams"])
        print(f"[engine_ab] {name} {trees[name]}: "
              f"{statistics.median(r['per_step']) * 1e3:.3f} ms a step "
              f"(median of {len(r['per_step'])}: " + ", ".join(
                  f"{t * 1e3:.3f}" for t in r["per_step"])
              + f"), {r['steps']} steps, B1 fused {r['launches']}",
              flush=True)
    if len(streams) == 2 and streams["A"] != streams["B"]:
        print("[engine_ab] the two trees' streams differ", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card.splitlines()[0] if card else "not read")
    return 0


if __name__ == "__main__":
    sys.exit(main())
