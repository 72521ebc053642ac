"""Reading the program's own profiler ranges in a traced window
(``repro_torch.runtime.trace.span``: ``tdvmm.program`` around weight
programming, ``model.prefill`` / ``model.decode`` around a model step,
``engine.tick`` around an engine tick), on ``devtrace.Event`` lists.

A device operation belongs to the range in which the host call that queued
it started, whenever it ran on the card.  ``devtrace.Event`` carries no
correlation id, so each device operation is paired with its launch call by
order, one kind at a time (kernels with kernel launches, copies with copy
calls, sets with set calls): the program queues all its work on one stream,
which runs it in the order it was queued, so the i-th kernel of the trace is
the one the i-th kernel launch queued.  A program whose trace holds none of
these ranges (one older than them) reads nothing here.
"""
from __future__ import annotations

import collections

from perfbench import devtrace
from perfbench.devtrace import Event

PROGRAM = "tdvmm.program"
MODEL_PREFIX = "model."
TICK = "engine.tick"

# the host calls that queue one device operation, by kind (the CUDA
# runtime's, and the ``cu*`` calls libraries make below it)
CALLS = {
    "kernel": ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx"),
    "copy": ("cudaMemcpyAsync", "cudaMemcpy"),
    "set": ("cudaMemsetAsync", "cudaMemset"),
}
_KIND = {call: kind for kind, calls in CALLS.items() for call in calls}

# host calls that wait for the device
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def _op_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "set"
    return "kernel"


def ranges(events: list[Event], match) -> list[tuple[int, int]]:
    """(start, end) ns of the host annotations whose name ``match`` accepts,
    in start order."""
    return sorted((e.start_ns, e.start_ns + e.dur_ns) for e in events
                  if e.annotation and not e.device and match(e.name))


def union(iv) -> list[tuple[int, int]]:
    """Intervals merged where they overlap or touch, in order."""
    out: list[list[int]] = []
    for a, b in sorted(iv):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def launched(events: list[Event]) -> list[tuple[int, Event]]:
    """(start ns of the host call that queued it, device operation) for
    every device operation of the trace, paired by order with the launch
    calls of its kind; an operation with no call left to pair is left
    out."""
    calls: dict[str, list[int]] = collections.defaultdict(list)
    ops: dict[str, list[Event]] = collections.defaultdict(list)
    for e in events:
        if e.device:
            ops[_op_kind(e.name)].append(e)
        elif not e.annotation and e.name in _KIND:
            calls[_KIND[e.name]].append(e.start_ns)
    out = []
    for kind, evs in ops.items():
        evs.sort(key=lambda e: e.start_ns)
        out.extend(zip(sorted(calls[kind]), evs))
    return out


def _inside(t: int, iv: list[tuple[int, int]]) -> int:
    """The index of the interval of ``iv`` (sorted, disjoint) holding ``t``,
    else -1."""
    lo, hi = 0, len(iv)
    while lo < hi:
        mid = (lo + hi) // 2
        if iv[mid][0] <= t:
            lo = mid + 1
        else:
            hi = mid
    return lo - 1 if lo and t <= iv[lo - 1][1] else -1


def _overlap(x: list[tuple[int, int]], y: list[tuple[int, int]]) -> int:
    """Nanoseconds covered by both ``x`` and ``y`` (each sorted and
    disjoint)."""
    i = j = tot = 0
    while i < len(x) and j < len(y):
        tot += max(0, min(x[i][1], y[j][1]) - max(x[i][0], y[j][0]))
        if x[i][1] <= y[j][1]:
            i += 1
        else:
            j += 1
    return tot


def owned_s(events: list[Event], name: str) -> float | None:
    """Seconds of the window in which a device operation queued inside a
    range named ``name`` ran (overlaps counted once); None where the trace
    holds no such range."""
    spans = union(ranges(events, lambda n: n == name))
    if not spans:
        return None
    lo, hi = devtrace.window(events)
    own = union((e.start_ns, e.start_ns + e.dur_ns)
                for t, e in launched(events) if _inside(t, spans) >= 0)
    return sum(max(0, min(b, hi) - max(a, lo)) for a, b in own) / 1e9


def per_range_device_s(events: list[Event], name: str) -> list[float]:
    """For each range named ``name`` that starts inside the window, the
    device seconds (overlaps counted once) of the operations queued inside
    it, wherever they ran; ranges of that name must not overlap."""
    lo, hi = devtrace.window(events)
    spans = [s for s in ranges(events, lambda n: n == name)
             if lo <= s[0] < hi]
    mine: list[list[tuple[int, int]]] = [[] for _ in spans]
    for t, e in launched(events):
        i = _inside(t, spans)
        if i >= 0:
            mine[i].append((e.start_ns, e.start_ns + e.dur_ns))
    return [sum(b - a for a, b in union(iv)) / 1e9 for iv in mine]


def idle_inside_s(events: list[Event], prefix: str) -> float | None:
    """Seconds of the window in which no device operation ran while the
    host was inside a range whose name starts with ``prefix`` (nested ones
    included); None where the trace holds no such range."""
    spans = union(ranges(events, lambda n: n.startswith(prefix)))
    if not spans:
        return None
    lo, hi = devtrace.window(events)
    busy = union((max(e.start_ns, lo), min(e.start_ns + e.dur_ns, hi))
                 for e in events if e.device)
    gaps, cur = [], lo
    for a, b in busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        gaps.append((cur, hi))
    return _overlap(gaps, spans) / 1e9


def syncs_per_range(events: list[Event], name: str) -> float | None:
    """Host calls that wait for the device (``SYNCS``) started inside a
    range named ``name``, over the number of such ranges in the window;
    None where there is none."""
    lo, hi = devtrace.window(events)
    spans = [s for s in ranges(events, lambda n: n == name)
             if lo <= s[0] < hi]
    if not spans:
        return None
    merged = union(spans)
    n = sum(1 for e in events
            if not e.device and not e.annotation and e.name in SYNCS
            and _inside(e.start_ns, merged) >= 0)
    return n / len(spans)
