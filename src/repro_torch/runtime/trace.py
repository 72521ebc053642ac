"""Tracing for the port: request-level spans of the serving engine
(Chrome-trace export, the port's copy of ``repro.runtime.trace``) and
profiler ranges around the program's own work (``span``).

Two mechanisms, two clocks:

  * :class:`Tracer` records the engine's request lifecycle on its own
    **cumulative engine clock** (below).  It is the operator's view of one
    serving run: exported by ``serve --trace-out``, read by
    ``launch/trace_report`` and held event for event against the JAX
    package's tracer by the tests.  Its clock is summed tick wall-time, so
    it rides a snapshot and a restore; it shares no clock with the device.
  * :func:`span` opens a ``torch.profiler.record_function`` range while a
    ``torch.profiler`` profile is recording, and nothing otherwise.  The ranges
    land in the profiler's own trace, on the profiler's clock beside the
    card's kernels, and the CUDA activity trace links every kernel to the
    launch call that queued it, so a kernel is owned by the range its launch
    fell in, whenever it ran.  Four ranges exist, one per unit of work a
    reader attributes device time to: ``tdvmm.program`` (one call of
    ``core/quant.program_weights``: weight programming), ``model.prefill``
    (``models/model.prefill_step`` and ``prefill_chunk``), ``model.decode``
    (``decode_step`` and ``decode_slots``) and ``engine.tick`` (one
    ``runtime/engine.Engine.tick``).

The Tracer's engine clock stays as it is, not the profiler's: a trace must
continue across a kill and restore in a fresh process, and its events must
equal the JAX reference's, neither of which a wall or profiler clock gives.

The engine's whole request lifecycle — ``queued -> admitted ->
prefill_chunk[i] -> decode tick -> finished/evicted/rejected/over_budget``
— is recorded as structured spans and events by a :class:`Tracer` threaded
through ``runtime/engine.py``.  Everything is host-side bookkeeping between
the two step programs: the tracer reads host integers and floats only,
never a device tensor, so tracing adds no device sync and no step shape
(``step_shapes == 2`` holds), and a traced run's streams equal an untraced
one's.

Export is standard Chrome Trace Event Format (load ``chrome_trace()``'s
JSON in Perfetto / ``chrome://tracing``):

  * **pid 0 "engine"**, tid 0 "ticks": one ``X`` (complete) slice per
    engine tick, named by what the tick did (``prefill_chunk[i]`` /
    ``decode`` / ``idle``) with the tick's host wall duration, plus ``C``
    counter tracks (queue depth, active slots, pages in use, fJ/Op).
  * **pid 1 "requests"**, tid = rid: every request is its own thread with
    a strict ``B``/``E`` span stack — ``queued``, then ``prefill``, then
    ``decode`` — closed by an instant ``finish:<reason>`` marker.  Span
    boundary ``args`` carry the engine step id, slot, dp-rank, and page
    count, so span boundaries can be cross-checked against
    ``EngineReport`` exactly.

**What a tick slice measures.**  The engine times each tick with the host
clock and the tracer advances by it.  On a CUDA card the host runs ahead of
the device: a prefill chunk that does not emit a token returns once its
kernels are queued, and its device time shows up in the next tick that
reads a result back (the chunk that emits a token, or a decode step).  So
a tick slice is host wall time, including whatever device wait that tick
absorbed — not the device time of that tick's own kernels.  The engine
adds no sync to make it so (the JAX package's engine has none either); a
profiler's trace gives a tick's own device time, from its ``engine.tick``
range, instead.

Timestamps come from the tracer's own **cumulative engine clock**
(microseconds of summed tick wall-time, advanced only in ``tick_done``),
not a wall clock: the clock rides ``snapshot()``/``restore()`` together
with all open spans, so a preempted engine restored in a fresh process
continues the *same* trace — one continuous, schema-valid file across a
kill and restore (engine snapshot meta version 4).

``validate_chrome_trace`` is the shared schema check (tests, the card's
smoke run): integer pid/tid, non-decreasing ``ts`` per (pid, tid),
balanced stack-disciplined ``B``/``E`` pairs.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["Tracer", "validate_chrome_trace", "span", "ENGINE_PID",
           "REQUEST_PID"]

ENGINE_PID = 0
REQUEST_PID = 1

_PHASES = ("B", "E", "X", "C", "i", "M")

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a ``torch.profiler`` profile
    is recording; else one shared no-op context (an unguarded
    ``record_function`` costs its entry even with no profiler, on every call
    of the hot path)."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


class Tracer:
    """Span/event recorder for one engine's request lifecycle.

    ``max_events`` is a soft cap: once reached, *droppable* events (tick
    slices, counters) are counted in ``dropped`` instead of stored, while
    span boundaries, finish markers, and metadata always land — so the
    exported trace stays balanced and schema-valid no matter how long the
    engine serves.
    """

    def __init__(self, max_events: int = 200_000):
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        self.max_events = int(max_events)
        self.clock_us = 0.0            # cumulative engine wall-time, us
        self.ticks = 0
        self.dropped = 0
        self.events: list[dict] = []
        self._phase: dict[int, str] = {}   # rid -> open span name
        self._req: dict[int, dict] = {}    # rid -> waterfall bookkeeping
        self._named: set[str] = set()      # emitted metadata keys
        self._pending = None               # (name, args) slice of this tick
        self._emit_meta("process_name", ENGINE_PID, 0, "engine")
        self._emit_meta("process_name", REQUEST_PID, 0, "requests")
        self._emit_meta("thread_name", ENGINE_PID, 0, "ticks")

    # ------------------------------------------------------------------
    # Low-level emit
    # ------------------------------------------------------------------
    def _append(self, ev: dict, droppable: bool = False) -> None:
        if droppable and len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def _emit_meta(self, kind: str, pid: int, tid: int, name: str) -> None:
        key = f"{kind}:{pid}:{tid}"
        if key in self._named:
            return
        self._named.add(key)
        self.events.append({"ph": "M", "name": kind, "pid": pid, "tid": tid,
                            "ts": 0, "args": {"name": name}})

    def _close_phase(self, rid: int, step: int):
        ph = self._phase.pop(rid, None)
        if ph is None:
            return None
        self._append({"ph": "E", "name": ph, "pid": REQUEST_PID, "tid": rid,
                      "ts": self.clock_us, "args": {"step": step}})
        return ph

    # ------------------------------------------------------------------
    # Engine hooks (all stamped at the current tick's start clock)
    # ------------------------------------------------------------------
    def attach(self, requests) -> None:
        """Reset per-request state for a fresh ``Engine.start`` over these
        requests (a reused tracer appends a new run to the same file;
        ``restore`` does NOT call this — resumed spans stay open)."""
        for r in requests:
            rid = int(r.rid)
            self._phase.pop(rid, None)
            self._req.pop(rid, None)
        self._pending = None

    def note_arrival(self, rid: int, step: int) -> None:
        """A request became visible to the scheduler: open ``queued``.
        Idempotent — later ticks over the same pending request no-op."""
        if rid in self._req:
            return
        self._emit_meta("thread_name", REQUEST_PID, rid, f"req {rid}")
        self._req[rid] = {"queued_us": self.clock_us, "queued_step": step,
                          "chunks": 0}
        self._phase[rid] = "queued"
        self._append({"ph": "B", "name": "queued", "pid": REQUEST_PID,
                      "tid": rid, "ts": self.clock_us,
                      "args": {"step": step}})

    def admitted(self, rid: int, step: int, sid: int, dp_rank: int,
                 pages: int) -> None:
        """``queued -> prefill``: the request took a slot and its pages."""
        if rid not in self._req:       # defensive: arrival was never seen
            self.note_arrival(rid, step)
        self._close_phase(rid, step)
        self._phase[rid] = "prefill"
        self._req[rid].update(admitted_us=self.clock_us, admitted_step=step,
                              slot=sid, dp_rank=dp_rank)
        self._append({"ph": "B", "name": "prefill", "pid": REQUEST_PID,
                      "tid": rid, "ts": self.clock_us,
                      "args": {"step": step, "slot": sid,
                               "dp_rank": dp_rank, "pages": pages}})

    def mark_chunk(self, rid: int, index: int, tokens: int, done: bool,
                   step: int) -> None:
        """One prefill chunk ran this tick; ``done`` moves the request's
        span from ``prefill`` to ``decode``."""
        self._pending = (f"prefill_chunk[{index}]",
                         {"rid": rid, "tokens": tokens, "step": step})
        info = self._req.get(rid)
        if info is not None:
            info["chunks"] = info.get("chunks", 0) + 1
        if done:
            self._close_phase(rid, step)
            self._phase[rid] = "decode"
            if info is not None:
                info["decode_start_us"] = self.clock_us
                info["decode_start_step"] = step
            self._append({"ph": "B", "name": "decode", "pid": REQUEST_PID,
                          "tid": rid, "ts": self.clock_us,
                          "args": {"step": step}})

    def mark_decode(self, rids, step: int) -> None:
        """One batched decode step ran this tick over ``rids``."""
        self._pending = ("decode", {"batch": len(rids),
                                    "rids": [int(r) for r in rids],
                                    "step": step})

    def mark_idle(self, step: int, until: int) -> None:
        """The engine fast-forwarded to the next arrival."""
        self._pending = ("idle", {"from_step": step, "to_step": until,
                                  "skipped": until - step})

    def finished(self, rid: int, step: int, reason: str) -> None:
        """Terminal transition: close whatever span is open and drop an
        instant ``finish:<reason>`` marker (works from any phase —
        ``rejected``/``evicted`` requests die straight out of ``queued``)."""
        self._close_phase(rid, step)
        info = self._req.setdefault(
            rid, {"queued_us": self.clock_us, "queued_step": step,
                  "chunks": 0})
        info.update(finished_us=self.clock_us, finished_step=step,
                    reason=reason)
        self._append({"ph": "i", "name": f"finish:{reason}", "s": "t",
                      "pid": REQUEST_PID, "tid": rid, "ts": self.clock_us,
                      "args": {"step": step}})

    def tick_done(self, step: int, dt: float, counters=None) -> None:
        """End of one engine tick: flush this tick's slice with its host
        wall duration ``dt`` (seconds), emit counter samples, advance the
        engine clock.
        This is the ONLY place the clock moves — every intra-tick event is
        stamped at the tick's start."""
        dur = max(float(dt), 0.0) * 1e6
        if self._pending is not None:
            name, args = self._pending
            self._pending = None
            self._append({"ph": "X", "name": name, "pid": ENGINE_PID,
                          "tid": 0, "ts": self.clock_us, "dur": dur,
                          "args": args}, droppable=True)
        self.clock_us += dur
        self.ticks += 1
        for metric, value in (counters or {}).items():
            self._append({"ph": "C", "name": metric, "pid": ENGINE_PID,
                          "tid": 0, "ts": self.clock_us,
                          "args": {metric: float(value)}}, droppable=True)

    # ------------------------------------------------------------------
    # Export
    # ------------------------------------------------------------------
    def chrome_trace(self) -> dict:
        """The trace as a Chrome Trace Event Format document (Perfetto /
        ``chrome://tracing`` loadable).  Spans still open (a preempted or
        in-flight run) are auto-closed at the current clock **on the
        exported copy only** — the live tracer keeps them open so a
        restored engine continues them."""
        evs = list(self.events)
        for rid in sorted(self._phase):
            evs.append({"ph": "E", "name": self._phase[rid],
                        "pid": REQUEST_PID, "tid": rid, "ts": self.clock_us,
                        "args": {"auto_closed": True}})
        return {"traceEvents": evs, "displayTimeUnit": "ms"}

    def summary(self) -> dict:
        """Per-request latency waterfall (queue-wait vs prefill vs decode,
        in engine-clock us) + p50/p95/p99 across requests — the
        ``EngineReport.trace_summary`` payload; ``launch/trace_report.py``
        renders the exported document as markdown."""
        per_req: dict[str, dict] = {}
        cols = {"queue_wait_us": [], "prefill_us": [], "decode_us": [],
                "total_us": []}
        for rid in sorted(self._req):
            info = self._req[rid]
            q = info.get("queued_us")
            a = info.get("admitted_us")
            d = info.get("decode_start_us")
            f = info.get("finished_us")
            row = {
                "queued_step": info.get("queued_step"),
                "admitted_step": info.get("admitted_step"),
                "finished_step": info.get("finished_step"),
                "reason": info.get("reason"),
                "chunks": info.get("chunks", 0),
                "queue_wait_us": a - q if None not in (a, q) else None,
                "prefill_us": d - a if None not in (d, a) else None,
                "decode_us": f - d if None not in (f, d) else None,
                "total_us": f - q if None not in (f, q) else None,
            }
            per_req[str(rid)] = row
            for k in cols:
                if row[k] is not None:
                    cols[k].append(row[k])
        pct = {}
        for k, vs in cols.items():
            if vs:
                pct[k] = {"p50": float(np.percentile(vs, 50)),
                          "p95": float(np.percentile(vs, 95)),
                          "p99": float(np.percentile(vs, 99)),
                          "mean": float(np.mean(vs)), "n": len(vs)}
            else:
                pct[k] = {"p50": 0.0, "p95": 0.0, "p99": 0.0,
                          "mean": 0.0, "n": 0}
        return {"ticks": self.ticks, "events": len(self.events),
                "dropped": self.dropped, "clock_us": self.clock_us,
                "requests": per_req, "percentiles": pct}

    # ------------------------------------------------------------------
    # Snapshot / restore (rides in Engine.snapshot()'s meta leaf, version 4)
    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        return {"version": 1,
                "clock_us": self.clock_us,
                "ticks": self.ticks,
                "dropped": self.dropped,
                "events": [dict(e) for e in self.events],
                "phase": {str(r): p for r, p in self._phase.items()},
                "req": {str(r): dict(i) for r, i in self._req.items()},
                "named": sorted(self._named)}

    def restore(self, snap: dict) -> None:
        if not isinstance(snap, dict) or "events" not in snap:
            raise ValueError("not a Tracer snapshot")
        self.clock_us = float(snap["clock_us"])
        self.ticks = int(snap["ticks"])
        self.dropped = int(snap["dropped"])
        self.events = [dict(e) for e in snap["events"]]
        self._phase = {int(r): p for r, p in snap["phase"].items()}
        self._req = {int(r): dict(i) for r, i in snap["req"].items()}
        self._named = set(snap["named"])
        self._pending = None          # the interrupted tick re-runs


# --------------------------------------------------------------------------
# Schema validation (shared by the tests and the card's smoke run)
# --------------------------------------------------------------------------
def validate_chrome_trace(doc) -> dict:
    """Validate a Chrome Trace Event Format document.

    Checks: known phase types, integer pid/tid on every event, numeric
    non-decreasing ``ts`` per (pid, tid) track, non-negative ``dur`` on
    complete slices, and balanced stack-disciplined ``B``/``E`` pairs whose
    names match.  Raises ``ValueError`` on the first violation; returns
    per-phase event counts on success.
    """
    evs = doc.get("traceEvents") if isinstance(doc, dict) else doc
    if not isinstance(evs, list) or not evs:
        raise ValueError("trace has no traceEvents list")
    last_ts: dict[tuple, float] = {}
    stacks: dict[tuple, list] = {}
    counts: dict[str, int] = {}
    for i, ev in enumerate(evs):
        ph = ev.get("ph")
        if ph not in _PHASES:
            raise ValueError(f"event {i}: unknown phase {ph!r}")
        counts[ph] = counts.get(ph, 0) + 1
        pid, tid = ev.get("pid"), ev.get("tid")
        if not isinstance(pid, int) or not isinstance(tid, int) \
                or isinstance(pid, bool) or isinstance(tid, bool):
            raise ValueError(f"event {i}: pid/tid must be ints, got "
                             f"{pid!r}/{tid!r}")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or isinstance(ts, bool):
            raise ValueError(f"event {i}: ts must be numeric, got {ts!r}")
        key = (pid, tid)
        prev = last_ts.get(key)
        if prev is not None and ts < prev:
            raise ValueError(
                f"event {i}: ts {ts} regresses below {prev} on "
                f"pid={pid} tid={tid}")
        last_ts[key] = float(ts)
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: X slice needs dur >= 0, "
                                 f"got {dur!r}")
        elif ph == "B":
            stacks.setdefault(key, []).append(ev.get("name"))
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                raise ValueError(f"event {i}: E without open B on "
                                 f"pid={pid} tid={tid}")
            opened = stack.pop()
            name = ev.get("name")
            if name is not None and name != opened:
                raise ValueError(
                    f"event {i}: E {name!r} does not match open B "
                    f"{opened!r} on pid={pid} tid={tid}")
    unbalanced = {k: v for k, v in stacks.items() if v}
    if unbalanced:
        raise ValueError(f"unbalanced B spans left open: {unbalanced}")
    return counts
