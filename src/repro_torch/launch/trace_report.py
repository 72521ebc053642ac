"""Render an engine Chrome-trace JSON as a markdown latency report.

Standalone summarizer over the ``launch/serve.py --trace-out`` (or
``runtime.trace.Tracer.chrome_trace``) artifact — it parses the Chrome
Trace Event Format document directly (no engine state needed), so it works
on any archived trace:

    PYTHONPATH=src python -m repro_torch.launch.trace_report trace.json
    PYTHONPATH=src python -m repro_torch.launch.trace_report trace.json \\
        -o report.md

Output: a per-request latency waterfall table (queue-wait vs prefill vs
decode, reconstructed from the ``queued``/``prefill``/``decode`` span
stack on each request thread) plus p50/p95/p99 percentiles across
requests, and a per-tick phase breakdown from the engine-tick slices (host
wall time per tick: see ``runtime.trace``).  The same functions and the
same markdown as the JAX package's ``scripts/trace_report.py``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from repro_torch.runtime.trace import (ENGINE_PID, REQUEST_PID,
                                       validate_chrome_trace)

_SPANS = ("queued", "prefill", "decode")


def load_events(path) -> list[dict]:
    doc = json.loads(Path(path).read_text())
    validate_chrome_trace(doc)
    return doc["traceEvents"] if isinstance(doc, dict) else doc


def request_waterfalls(events: list[dict]) -> dict[int, dict]:
    """rid -> span durations (us) + finish info, via B/E stack matching."""
    out: dict[int, dict] = {}
    open_at: dict[tuple, list] = {}
    for ev in events:
        if ev.get("pid") != REQUEST_PID:
            continue
        rid = ev["tid"]
        row = out.setdefault(rid, {"reason": None, "steps": {}})
        ph, name = ev.get("ph"), ev.get("name")
        if ph == "B":
            open_at.setdefault((rid, name), []).append(ev["ts"])
        elif ph == "E":
            starts = open_at.get((rid, name))
            if starts:
                row[f"{name}_us"] = ev["ts"] - starts.pop()
                row["steps"][name] = ev.get("args", {}).get("step")
        elif ph == "i" and isinstance(name, str) \
                and name.startswith("finish:"):
            row["reason"] = name.split(":", 1)[1]
            row["finished_step"] = ev.get("args", {}).get("step")
    return out


def tick_breakdown(events: list[dict]) -> dict[str, dict]:
    """Engine-tick slice stats grouped by phase kind (prefill/decode/idle)."""
    buckets: dict[str, list[float]] = {}
    for ev in events:
        if ev.get("pid") != ENGINE_PID or ev.get("ph") != "X":
            continue
        name = ev.get("name", "")
        kind = "prefill" if name.startswith("prefill_chunk") else name
        buckets.setdefault(kind, []).append(float(ev.get("dur", 0.0)))
    return {
        kind: {"ticks": len(durs), "total_us": float(np.sum(durs)),
               "mean_us": float(np.mean(durs)),
               "p95_us": float(np.percentile(durs, 95))}
        for kind, durs in sorted(buckets.items())}


def _fmt_us(v) -> str:
    return f"{v:,.0f}" if v is not None else "-"


def render_markdown(path) -> str:
    events = load_events(path)
    reqs = request_waterfalls(events)
    ticks = tick_breakdown(events)
    lines = [f"# Trace report: `{path}`", ""]

    lines += ["## Per-request latency waterfall (engine-clock µs)", "",
              "| rid | reason | finish step | queue wait | prefill "
              "| decode | total |",
              "|---:|---|---:|---:|---:|---:|---:|"]
    cols = {k: [] for k in ("queued_us", "prefill_us", "decode_us",
                            "total_us")}
    for rid in sorted(reqs):
        row = reqs[rid]
        parts = [row.get(f"{s}_us") for s in _SPANS]
        total = sum(p for p in parts if p is not None) \
            if any(p is not None for p in parts) else None
        for key, val in zip(("queued_us", "prefill_us", "decode_us"), parts):
            if val is not None:
                cols[key].append(val)
        if total is not None:
            cols["total_us"].append(total)
        lines.append(
            f"| {rid} | {row.get('reason') or '?'} "
            f"| {row.get('finished_step', '-')} "
            f"| {_fmt_us(parts[0])} | {_fmt_us(parts[1])} "
            f"| {_fmt_us(parts[2])} | {_fmt_us(total)} |")

    lines += ["", "## Percentiles across requests (µs)", "",
              "| phase | p50 | p95 | p99 | mean | n |",
              "|---|---:|---:|---:|---:|---:|"]
    labels = {"queued_us": "queue wait", "prefill_us": "prefill",
              "decode_us": "decode", "total_us": "total"}
    for key, label in labels.items():
        vs = cols[key]
        if vs:
            lines.append(
                f"| {label} | {_fmt_us(np.percentile(vs, 50))} "
                f"| {_fmt_us(np.percentile(vs, 95))} "
                f"| {_fmt_us(np.percentile(vs, 99))} "
                f"| {_fmt_us(np.mean(vs))} | {len(vs)} |")
        else:
            lines.append(f"| {label} | - | - | - | - | 0 |")

    lines += ["", "## Engine ticks by phase", "",
              "| phase | ticks | total µs | mean µs | p95 µs |",
              "|---|---:|---:|---:|---:|"]
    for kind, s in ticks.items():
        lines.append(f"| {kind} | {s['ticks']} | {_fmt_us(s['total_us'])} "
                     f"| {_fmt_us(s['mean_us'])} | {_fmt_us(s['p95_us'])} |")
    lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="Chrome-trace JSON from --trace-out")
    ap.add_argument("-o", "--out", default=None,
                    help="write markdown here (default: stdout)")
    args = ap.parse_args(argv)
    md = render_markdown(args.trace)
    if args.out:
        Path(args.out).write_text(md)
        print(f"[trace_report] wrote {args.out}")
    else:
        print(md)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
