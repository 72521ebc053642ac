"""One run of one cell: set-up, the measured window, the trace, the check
against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:
``perfbench/configs/<config>.json``, ``perfbench/traffic/<traffic>.json``
(whose ``driver`` names ``perfbench/drivers/<driver>.py``),
``perfbench/metrics/<metric>.py`` (a metric ``a.b`` is read by
``metrics/a.py`` with the suffix ``b``), ``perfbench/limits/<cell>.json``
and the comparison that decides ``correct``, ``perfbench/checks/<check>.py``
(named by the traffic file's ``check``).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Optional

from perfbench import devtrace, work

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
ROOT = Path.cwd()
BENCH = ROOT / "perfbench"


@dataclasses.dataclass
class Record:
    """What a driver's window gives the metric readers and the judge."""
    kind: str                                  # prefill | decode | train
    window_s: float = 0.0
    setup_s: float = 0.0
    step_s: dict = dataclasses.field(default_factory=dict)   # kind -> [s]
    tokens: dict = dataclasses.field(default_factory=dict)   # kind -> n
    itl_s: list = dataclasses.field(default_factory=list)
    work: work.Tally = dataclasses.field(default_factory=work.Tally)
    attempted: int = 0
    failed: int = 0
    samples: list = dataclasses.field(default_factory=list)
    events: Optional[list] = None              # the traced window
    peaks: dict = dataclasses.field(default_factory=dict)
    dtype: str = "bfloat16"
    extra: dict = dataclasses.field(default_factory=dict)

    def add_step(self, kind: str, seconds: float) -> None:
        self.step_s.setdefault(kind, []).append(seconds)


@dataclasses.dataclass
class Cell:
    """A cell resolved from ``BENCHMARK.json`` and its data files."""
    name: str
    config: dict            # the configuration file
    mix: dict               # the traffic file
    limits: dict            # the limits file ({} when there is none)
    calibration: Any = None  # the run's calibration batch (B, S) ids

    @property
    def run(self) -> dict:
        return self.config["run"]


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def resolve(workload: str, bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    lim = BENCH / "limits" / f"{workload}.json"
    return Cell(workload, load_json(ROOT / conf["file"]),
                load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                load_json(lim) if lim.exists() else {})


def port_config(run: dict):
    """The program's ModelConfig for a configuration file's ``run``."""
    from repro_torch.configs.archs import get_config
    from repro_torch.configs.base import TDVMMPlan, tdvmm_rule
    cfg = get_config(run["arch"])
    moe = dataclasses.replace(
        cfg.moe, n_experts=run["n_experts"], top_k=run["top_k"],
        d_ff=run["expert_d_ff"], n_shared_experts=run["n_shared_experts"],
        capacity_factor=run["capacity_factor"], first_k_dense=0)
    rule = tdvmm_rule(run["tdvmm"], enabled=True, bits=run["bits"],
                      weight_bits=run["bits"])
    return cfg.replace(
        n_layers=run["n_layers"], d_model=run["d_model"],
        n_heads=run["n_heads"], n_kv_heads=run["n_kv_heads"],
        head_dim=run["head_dim"], vocab_size=run["vocab_size"],
        rope_theta=run["rope_theta"], swa_window=None,
        norm_eps=run["norm_eps"], dtype=run["dtype"], moe=moe,
        tdvmm_plan=TDVMMPlan(rules=(rule,)))


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def metric_reader(name: str):
    fam, _, suffix = name.partition(".")
    return importlib.import_module(f"perfbench.metrics.{fam}"), suffix


def wanted(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics this cell reports in a run: its end-to-end ones, or with
    the trace its per-layer ones."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]


def read_metrics(rec: Record, metrics: list[dict]) -> dict:
    out = {}
    for m in metrics:
        mod, suffix = metric_reader(m["name"])
        v = mod.read(rec, suffix)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, cell: Optional[Cell] = None,
             bench: Optional[dict] = None, driver_patch=None,
             control: bool = False) -> dict:
    """One run; returns the result object (without printing it).  ``cell``
    and ``bench`` replace the files (tests at a small size), and
    ``driver_patch`` is called on the driver after its set-up (tests that
    break the timed path)."""
    import torch
    from perfbench import peaks as peaks_lib, traffic
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    cell = cell if cell is not None else resolve(workload, bench)
    device = torch.device(device) if device is not None else \
        torch.device("cuda", 0)
    on_card = device.type == "cuda"
    device_kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    cell.calibration = traffic.calibration_batch(
        cell.mix, seed, cell.run["vocab_size"])
    drv_mod = importlib.import_module(
        f"perfbench.drivers.{cell.mix['driver']}")
    drv = drv_mod.Driver(cell, seed, device, port_config(cell.run))
    drv.setup()
    if driver_patch is not None:
        driver_patch(drv)
    rec = Record(kind=drv.kind, dtype=cell.run["dtype"],
                 peaks=peaks_lib.for_device(device_kind) if on_card
                 else peaks_lib.PEAKS["NVIDIA H100"])
    if on_card:
        torch.cuda.synchronize(device)
    rec.setup_s = time.time() - t_start
    prof = None
    if trace and on_card:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    try:
        with torch.profiler.record_function(devtrace.WINDOW):
            drv.window(rec, seconds)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    dev: dict[str, Any] = {"platform": "gpu" if on_card else "cpu",
                           "kind": device_kind, "count": 1,
                           "memory_peak_bytes": int(peak)}
    breakdown = None
    if prof is not None:
        rec.events = devtrace.from_profiler(prof)
        del prof
        dev["busy_s"], dev["window_s"] = devtrace.busy_s(rec.events)
        breakdown = {"device_ops": devtrace.top_ops(rec.events),
                     "idle_gaps": devtrace.idle_gaps(rec.events)}
    if on_card:
        dev["power_limit_w"] = power_limit()
    metrics = read_metrics(rec, wanted(bench, workload, trace))
    params = drv.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    check = importlib.import_module(f"perfbench.checks.{cell.mix['check']}")
    checks, why = check.check(cell, rec, params, device, control)
    result = {"correct": not why, "attempted": rec.attempted,
              "failed": rec.failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["reference"] = rec.extra
    result["why_not_correct"] = why
    result["checks"] = checks
    return result


def main(argv: list[str], t_start: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if cell is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start, bench=bench)
    found = forbidden_modules()
    if found:
        print(f"the run loaded forbidden modules: {found}", file=sys.stderr)
        return 4
    if result["why_not_correct"]:
        print(f"not correct: {result['why_not_correct']}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


def cache_env(root: Path) -> None:
    """Every build and kernel cache the run may fill, at fixed paths inside
    the checkout (the program's own nvcc builds already live there)."""
    base = root / ".perfbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(base / sub)
