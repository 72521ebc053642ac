#!/usr/bin/env python3
"""Which collectives the gloo backend carries for CUDA tensors, on one card.

    python3 scripts/gloo_cuda_probe.py [--out FILE]

Two processes share device 0 in one gloo process group (NCCL takes one rank
per device, so two ranks on one card can only talk over gloo) and each
collective the port's mesh paths use is tried on CUDA tensors:
``all_reduce``, ``all_gather``, ``all_to_all_single`` and ``send``/``recv``
(``batch_isend_irecv``).  Prints one JSON object: per collective, whether it
ran and gave the right values, and the error when it did not.  Each
collective runs in a fresh pair of processes (a failed one can leave its
peer waiting), with a time limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import traceback

COLLECTIVES = ("all_reduce", "all_gather", "all_to_all_single", "send_recv")


def _rank(rank: int, init: str, results, names) -> None:
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=2)
    dev = torch.device("cuda", 0)
    out = {}
    for name in names:
        try:
            if name == "all_reduce":
                t = torch.full((4,), float(rank + 1), device=dev)
                dist.all_reduce(t)
                ok = bool((t == 3.0).all())
            elif name == "all_gather":
                parts = [torch.empty(3, device=dev) for _ in range(2)]
                dist.all_gather(parts, torch.full((3,), float(rank),
                                                  device=dev))
                ok = bool((parts[0] == 0).all() and (parts[1] == 1).all())
            elif name == "all_to_all_single":
                src = torch.arange(4, dtype=torch.float32, device=dev) \
                    + 10 * rank
                dst = torch.empty_like(src)
                dist.all_to_all_single(dst, src)
                want = torch.tensor([0, 1, 10, 11] if rank == 0
                                    else [2, 3, 12, 13], dtype=torch.float32,
                                    device=dev)
                ok = bool(torch.equal(dst, want))
            else:
                buf = torch.empty(2, device=dev)
                ops = [dist.P2POp(dist.isend, torch.full(
                    (2,), float(rank), device=dev), 1 - rank),
                    dist.P2POp(dist.irecv, buf, 1 - rank)]
                for w in dist.batch_isend_irecv(ops):
                    w.wait()
                ok = bool((buf == float(1 - rank)).all())
            torch.cuda.synchronize()
            dist.barrier()     # neither rank leaves while the other works
            out[name] = {"ok": ok}
        except Exception as e:                       # the probe's finding
            out[name] = {"ok": False, "error": f"{type(e).__name__}: "
                         f"{str(e).splitlines()[0][:300]}",
                         "trace": traceback.format_exc()[-600:]}
            break
    results.put((rank, out))
    results.close()
    results.join_thread()      # the result is written before the exit
    os._exit(0)                # a failed collective may leave gloo waiting


def main() -> int:
    import torch
    import torch.multiprocessing as mp
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    ctx = mp.get_context("spawn")
    found = {}
    for name in COLLECTIVES:
        results = ctx.Queue()
        with tempfile.TemporaryDirectory() as d:
            init = os.path.join(d, "init")
            procs = [ctx.Process(target=_rank,
                                 args=(r, init, results, (name,)))
                     for r in range(2)]
            for p in procs:
                p.start()
            got = []
            for _ in procs:
                try:
                    got.append(results.get(timeout=60)[1][name])
                except Exception:
                    got.append({"ok": False, "error": "timed out"})
            for p in procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.kill()
        if all(v["ok"] for v in got):
            found[name] = {"carried": True}
        else:
            found[name] = {"carried": False, "ranks": [
                v.get("error", "ok" if v["ok"] else "wrong values")
                for v in got]}
    doc = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "device": torch.cuda.get_device_name(0), "collectives": found}
    print(json.dumps(doc))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
