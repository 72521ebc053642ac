"""Reading the profiler's trace of a window: device busy time, device time
by kernel name, and the device's idle gaps labelled by what the host was
doing.  The profiler's events become plain ``Event`` tuples first, so the
arithmetic below also runs on a synthetic trace.
"""
from __future__ import annotations

import collections
from typing import NamedTuple

WINDOW = "bench.window"      # the harness's annotation around the window
STEP_PREFIX = "bench."       # its annotations around each step


class Event(NamedTuple):
    name: str
    start_ns: int
    dur_ns: int
    device: bool             # ran on the card (kernel, copy, set)
    annotation: bool         # a user annotation (record_function)


def from_profiler(prof) -> list[Event]:
    """The events of a finished ``torch.profiler.profile``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = str(e.device_type()).endswith("CUDA")
        ann = bool(e.is_user_annotation())
        if dev and ann:
            continue                 # the GPU copy of a host annotation
        out.append(Event(e.name(), int(e.start_ns()), int(e.duration_ns()),
                         dev, ann))
    return out


def window(events: list[Event]) -> tuple[int, int]:
    """(start, end) ns of the harness's window annotation."""
    for e in events:
        if e.annotation and e.name == WINDOW:
            return e.start_ns, e.start_ns + e.dur_ns
    raise ValueError("the trace holds no window annotation")


def _merged(events: list[Event], lo: int, hi: int) -> list[tuple[int, int]]:
    iv = sorted((max(e.start_ns, lo), min(e.start_ns + e.dur_ns, hi))
                for e in events if e.device)
    out: list[list[int]] = []
    for a, b in iv:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(events: list[Event]) -> tuple[float, float]:
    """(seconds in which an operation ran on the device, window seconds)."""
    lo, hi = window(events)
    busy = sum(b - a for a, b in _merged(events, lo, hi))
    return busy / 1e9, (hi - lo) / 1e9


def kernel_s(events: list[Event], patterns: tuple[str, ...]) -> float:
    """Device seconds inside the window of the operations whose name holds
    one of ``patterns``."""
    lo, hi = window(events)
    return sum(max(0, min(e.start_ns + e.dur_ns, hi) - max(e.start_ns, lo))
               for e in events if e.device
               and any(p in e.name for p in patterns)) / 1e9


def top_ops(events: list[Event], n: int = 10) -> list[list]:
    """The ``n`` device operations (by name) that took most time."""
    lo, hi = window(events)
    tot: dict[str, int] = collections.defaultdict(int)
    for e in events:
        if e.device:
            tot[e.name[:160]] += max(0, min(e.start_ns + e.dur_ns, hi)
                                     - max(e.start_ns, lo))
    best = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e9] for k, v in best if v > 0]


SHORT_GAP_NS = 20_000


def _innermost(evs: list[Event], t: int, none: str, scan: int = 20000) -> str:
    """The name of the latest-started event of ``evs`` (sorted by start)
    that covers time ``t``: with nested host spans, the innermost."""
    i = _bisect(evs, t)
    for e in reversed(evs[max(0, i - scan):i]):
        if e.start_ns + e.dur_ns >= t:
            return e.name
    return none


def _bisect(evs: list[Event], t: int) -> int:
    lo, hi = 0, len(evs)
    while lo < hi:
        mid = (lo + hi) // 2
        if evs[mid].start_ns <= t:
            lo = mid + 1
        else:
            hi = mid
    return lo


def idle_gaps(events: list[Event], n: int = 10) -> list[list]:
    """The device's idle time in the window, summed by what the host was
    doing at each gap's middle (the harness's innermost step annotation,
    then the innermost host operation), the ``n`` largest."""
    lo, hi = window(events)
    busy = _merged(events, lo, hi)
    gaps, cur = [], lo
    for a, b in busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        gaps.append((cur, hi))
    ops = sorted((e for e in events if not e.device and not e.annotation),
                 key=lambda e: e.start_ns)
    steps = sorted((e for e in events if e.annotation
                    and e.name.startswith(STEP_PREFIX) and e.name != WINDOW),
                   key=lambda e: e.start_ns)
    tot: dict[str, int] = collections.defaultdict(int)
    for a, b in gaps:
        if b - a < SHORT_GAP_NS:
            tot["between back-to-back operations (< 20 us)"] += b - a
            continue
        mid = (a + b) // 2
        label = (f"{_innermost(steps, mid, 'outside any step')} / "
                 f"{_innermost(ops, mid, 'no host op')}")
        tot[label[:160]] += b - a
    best = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e9] for k, v in best]
