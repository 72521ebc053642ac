"""The roofline report on the dry run's JSON.

``launch/dryrun.py`` writes one file per cell,
``<arch>__<shape>__<pod1|pod2>.json`` (pod1 the 16 x 16 mesh, pod2 the
2 x 16 x 16 one), into ``artifacts/dryrun_torch/``.  This module reads
them and needs no device:

    PYTHONPATH=src python -m repro_torch.launch.roofline_report \\
        [--dir artifacts/dryrun_torch] [--pod pod1|pod2|both]

It prints three things:

(a) ``generator_table``: the table of the JAX package's generator
    (``scripts/gen_roofline_md.py``) row for row, one per mesh: the dominant
    term, the three terms, MFU at the bound, the useful-FLOP ratio, the
    argument and temporary GB a device and what moves the dominant term;
    ``missing`` and ``skip`` rows where a cell has no result.  An ``error``
    cell gets a row of its own, where the JAX generator would stop on the
    missing roofline.
(b) ``compact_table``: one row per arch and one column per shape.  A cell
    holds the dominant term's letter (X collective, M memory, C compute),
    the bound ``step_time_lower_bound_s`` and the peak bytes a rank, each at
    pod1 / pod2 (one value where the two print alike), the bytes in bold
    where a rank does not fit the card (``fits_h100`` false); ``skipped``,
    ``error`` or ``missing`` where the cell has no result.
(c) ``summaries``: one string per cell in the format of the JAX package's
    ``benchmarks/roofline_report.py``:
    ``dom=…|tc=…|tm=…|tx=…|mfu=…|useful=…``, ``SKIP|<reason>`` or ``ERROR``.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path
from typing import Optional

DEFAULT_DIR = Path("artifacts") / "dryrun_torch"
PODS = ("pod1", "pod2")

# the generator's arch and shape order (scripts/gen_roofline_md.py)
ORDER = ["yi-34b", "qwen2.5-14b", "qwen1.5-0.5b", "nemotron-4-15b",
         "llava-next-mistral-7b", "musicgen-large", "mamba2-1.3b",
         "mixtral-8x7b", "kimi-k2-1t-a32b", "zamba2-2.7b"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

LETTER = {"collective": "X", "memory": "M", "compute": "C"}

GENERATOR_HEADER = (
    "| arch | shape | dom | t_comp (s) | t_mem (s) | t_coll (s) | MFU@bound "
    "| useful-FLOP ratio | GB/dev (args+temp) | what moves the dominant term "
    "|\n|---|---|---|---|---|---|---|---|---|---|")


def fmt(x, digits=3):
    if x == 0:
        return "0"
    return f"{x:.{digits}g}"


def bottleneck_fix(d):
    r = d["roofline"]
    dom = r["dominant"]
    arch, shape = d["arch"], d["shape"]
    if dom == "collective":
        return "cut TP degree / batch-shard more (model too small for 16-way TP)"
    if dom == "memory":
        if "moe" in arch or "kimi" in arch or "mixtral" in arch:
            return "shrink MoE dispatch buffers (bf16 buffers, local capacity)"
        if shape.startswith("decode"):
            return "KV-cache layout: avoid cache rewrite, quantize KV to int8"
        return "fuse elementwise chains / drop remat saves (bf16 residuals)"
    return "increase per-chip batch or reduce remat recompute"


def load_cell(art: Path, arch: str, shape: str, pod: str) -> Optional[dict]:
    """The cell's JSON, or None when the dry run has not written it."""
    f = Path(art) / f"{arch}__{shape}__{pod}.json"
    return json.loads(f.read_text()) if f.exists() else None


def generator_row(arch: str, shape: str, d: Optional[dict]) -> str:
    if d is None:
        return f"| {arch} | {shape} | — | missing |  |  |  |  |  |  |"
    if d["status"] == "skipped":
        return (f"| {arch} | {shape} | skip | full-attention: N/A per "
                "DESIGN §5 |  |  |  |  |  |  |")
    if d["status"] != "ok":
        return f"| {arch} | {shape} | — | error |  |  |  |  |  |  |"
    r = d["roofline"]
    mem = d.get("memory_analysis", {})
    tmp_gb = (mem.get("temp_size_in_bytes") or 0) / 2**30
    arg_gb = (mem.get("argument_size_in_bytes") or 0) / 2**30
    return (f"| {arch} | {shape} | {r['dominant'][:4]} "
            f"| {fmt(r['t_compute_s'])} | {fmt(r['t_memory_s'])} "
            f"| {fmt(r['t_collective_s'])} | {fmt(r['mfu_at_bound'], 2)} "
            f"| {fmt(r['model_to_hlo_flops'], 2)} "
            f"| {arg_gb:.1f}+{tmp_gb:.1f} | {bottleneck_fix(d)} |")


def generator_table(art: Path, pod: str = "pod1") -> str:
    """(a): the generator's markdown table for one mesh."""
    rows = [generator_row(arch, shape, load_cell(art, arch, shape, pod))
            for arch in ORDER for shape in SHAPES]
    return GENERATOR_HEADER + "\n" + "\n".join(rows)


def seconds(x: float) -> str:
    """Three significant digits in plain decimals, thousands separated."""
    if x == 0:
        return "0"
    if x >= 1000:
        return f"{x:,.0f}"
    return f"{x:.{max(0, 2 - math.floor(math.log10(abs(x))))}f}"


def gigabytes(n: float) -> str:
    g = n / 1e9
    return f"{g:.0f}" if g >= 100 else f"{g:.1f}"


def _pair(values: list[str]) -> str:
    return values[0] if len(set(values)) == 1 else " / ".join(values)


def compact_cell(cells: list[Optional[dict]]) -> str:
    """(b)'s cell from one JSON per mesh (None: missing)."""
    status = ["missing" if d is None else d["status"] for d in cells]
    if any(s != "ok" for s in status):
        if len(set(status)) == 1:
            return status[0]
        return " / ".join(s if s != "ok" else compact_cell([d])
                          for s, d in zip(status, cells))
    letters = _pair([LETTER[d["roofline"]["dominant"]] for d in cells])
    bound = _pair([seconds(d["roofline"]["step_time_lower_bound_s"])
                   for d in cells])
    peaks = [gigabytes(d["peak_bytes"]) if d["fits_h100"] else
             f"**{gigabytes(d['peak_bytes'])}**" for d in cells]
    return f"{letters} {bound} s; {_pair(peaks)} GB"


def compact_table(art: Path, pods=PODS) -> str:
    """(b): one row per arch, one column per shape."""
    lines = ["| arch | " + " | ".join(SHAPES) + " |",
             "|---|" + "---|" * len(SHAPES)]
    for arch in ORDER:
        lines.append(f"| {arch} | " + " | ".join(
            compact_cell([load_cell(art, arch, shape, pod) for pod in pods])
            for shape in SHAPES) + " |")
    return "\n".join(lines)


def summary(d: dict) -> str:
    """(c): the JAX package's per-cell roofline string."""
    if d["status"] == "skipped":
        return "SKIP|" + d["reason"][:60]
    if d["status"] != "ok":
        return "ERROR"
    r = d["roofline"]
    return (f"dom={r['dominant']}|tc={r['t_compute_s']:.3e}|"
            f"tm={r['t_memory_s']:.3e}|tx={r['t_collective_s']:.3e}|"
            f"mfu={r['mfu_at_bound']:.4f}|useful={r['model_to_hlo_flops']:.3f}")


def summaries(art: Path, pod: str = "pod1") -> list[tuple[str, str]]:
    """(c) for every cell of one mesh: (``<arch>__<shape>__<pod>``, the
    string), in file-name order."""
    return [(f.stem, summary(json.loads(f.read_text())))
            for f in sorted(Path(art).glob(f"*__{pod}.json"))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=str(DEFAULT_DIR),
                    help="the dry run's output directory")
    ap.add_argument("--pod", default="both", choices=(*PODS, "both"),
                    help="pod1: the 16 x 16 mesh, pod2: 2 x 16 x 16")
    args = ap.parse_args(argv)
    art = Path(args.dir)
    if not any(art.glob("*.json")):
        print(f"no dry-run results in {art}: run python -m "
              "repro_torch.launch.dryrun first", file=sys.stderr)
        return 1
    pods = PODS if args.pod == "both" else (args.pod,)
    for pod in pods:
        print(f"## {pod}: the generator's table\n")
        print(generator_table(art, pod))
        print()
    print(f"## {' / '.join(pods)}: dominant term, bound, peak bytes a rank\n")
    print(compact_table(art, pods))
    for pod in pods:
        print(f"\n## {pod}: per-cell summaries\n")
        for tag, text in summaries(art, pod):
            print(f"roofline_{tag}: {text}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
