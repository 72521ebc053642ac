"""The check of a served model: the served tokens (and the served logits
where the timed path hands them back) against the plain reference, after
the window (``perfbench.reference.judge``), each compared number against
its limit in ``perfbench/limits/<cell>.json``."""
from __future__ import annotations

import time

import torch

from perfbench.reference import judge as jd
from perfbench.reference.lm import Reference


def check(cell, rec, params: dict, device,
          control: bool = False) -> tuple[dict, str]:
    """The compared numbers, each with its limit (those the cell's limits
    file names; every reading goes to ``rec.extra``), and why a run is not
    correct ('' when it is).  ``control``: also the control's readings
    (the reference in float8 in the program's place)."""
    vocab = cell.run["vocab_size"]
    bad = [s for s in rec.samples
           if not s["tokens"] or min(s["tokens"]) < 0
           or max(s["tokens"]) >= vocab]
    if not rec.samples or bad:
        return {}, f"{len(bad)} of {len(rec.samples)} samples served no " \
                   "token or one outside the vocabulary"
    t0 = time.perf_counter()
    codes: dict = {}
    ref = Reference(params, cell.run, codes=codes)
    calib = torch.as_tensor(cell.calibration, device=device)
    with torch.no_grad():
        ref.calibrate(calib)
        c = jd.compare(ref, rec.samples, vocab, device)
        nums = jd.numbers(c)
        rec.extra["reference_s"] = time.perf_counter() - t0
        rec.extra["readings"] = nums
        rec.extra["gaps"] = jd.spread(c["gaps"])
        if control:
            low = Reference(params, cell.run, precision="fp8", codes=codes)
            low.calibrate(calib)
            c = jd.compare(ref, rec.samples, vocab, device, other=low)
            rec.extra["control"] = jd.numbers(c)
            rec.extra["control_gaps"] = jd.spread(c["gaps"])
    checks = {k: {"value": nums.get(k, float("inf")), "limit": lim["limit"]}
              for k, lim in cell.limits.items()}
    why = [f"{k} {c['value']:.6g} > limit {c['limit']}"
           for k, c in checks.items() if not c["value"] <= c["limit"]]
    if not checks:
        why.append("no limits for this cell")
    return checks, "; ".join(why)
