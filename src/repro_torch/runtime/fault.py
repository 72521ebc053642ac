"""Fault-tolerance runtime for the training loop: preemption handling, step
retry, straggler watch, heartbeat — the port's copy of
``repro.runtime.fault``.

  * PreemptionGuard — SIGTERM/SIGINT handler: sets a flag the train loop
    polls so it checkpoints and exits cleanly inside the eviction grace
    window.
  * Preempted       — the control-flow exception a polled loop raises to
    unwind to its checkpoint-and-exit path.  Deliberately NOT a
    RuntimeError: ``retry_step`` must never swallow a preemption as a
    transient failure.
  * retry_step      — bounded retry with capped, jittered exponential
    backoff for transient failures (a CUDA error surfaces as a
    RuntimeError).  A persistent failure re-raises with the attempt count
    attached; restart then auto-resumes from the latest checkpoint.  An
    optional ``guard`` is polled between attempts.
  * StragglerMonitor — per-step wall-time EWMA + threshold: logs and counts
    outlier steps.
  * Heartbeat       — liveness marker an external babysitter can watch.

Given a ``sink`` (``runtime.telemetry.MetricsSink``), the monitor streams
its stragglers as the ``straggler_dt_s`` series and the heartbeat its beat
count as the ``heartbeat`` series.
"""
from __future__ import annotations

import dataclasses
import json
import random
import signal
import time
from pathlib import Path
from typing import Callable, Optional


class Preempted(Exception):
    """Raised by a loop that observed ``PreemptionGuard.requested`` — unwind
    to the checkpoint-and-exit path.  Not a RuntimeError on purpose:
    ``retry_step`` retries RuntimeErrors and must let this propagate."""


class PreemptionGuard:
    def __init__(self):
        self.requested = False
        self._installed = False
        self._prev = {}

    def install(self):
        if self._installed:
            return self
        self._prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:  # not the main thread (tests)
                pass
        self._installed = True
        return self

    def _handler(self, signum, frame):
        self.requested = True

    def uninstall(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev = {}
        self._installed = False


def retry_step(fn: Callable, *args, retries: int = 2, backoff_s: float = 1.0,
               backoff_cap_s: float = 30.0, jitter: float = 0.1,
               on_retry: Optional[Callable[[int, Exception], None]] = None,
               guard: Optional[PreemptionGuard] = None,
               sleep: Callable[[float], None] = time.sleep,
               rng: Optional[random.Random] = None):
    """Run fn(*args); retry transient failures (RuntimeError) with
    exponential backoff.

    The backoff doubles per attempt, is capped at ``backoff_cap_s`` and
    carries ``jitter`` (uniform +/- fraction).  On exhaustion the final
    exception re-raises with ``retry_attempts`` set and a note.  ``guard``
    is polled before every attempt and between backoff sleep slices: a
    preemption raises :class:`Preempted` at once.  ``sleep``/``rng`` are
    injectable for tests."""
    rng = rng if rng is not None else random.Random()
    attempt = 0
    while True:
        if guard is not None and guard.requested:
            raise Preempted(f"preempted before retry attempt {attempt}")
        try:
            return fn(*args)
        except RuntimeError as e:
            attempt += 1
            if attempt > retries:
                e.retry_attempts = attempt
                e.add_note(f"retry_step: failed on attempt {attempt} of "
                           f"{retries + 1}")
                raise
            if on_retry:
                on_retry(attempt, e)
            delay = min(backoff_s * (2 ** (attempt - 1)), backoff_cap_s)
            if jitter:
                delay *= 1.0 + jitter * (2.0 * rng.random() - 1.0)
            # sleep in slices so a preemption mid-backoff is seen within
            # ~100 ms, not after the whole delay
            deadline = time.monotonic() + delay
            while True:
                if guard is not None and guard.requested:
                    raise Preempted(
                        f"preempted during retry backoff (attempt {attempt})")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                sleep(min(remaining, 0.1))


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 2.0          # x EWMA of recent step wall-times
    ewma_alpha: float = 0.1
    ewma: float = 0.0
    n: int = 0
    stragglers: int = 0
    log: list = dataclasses.field(default_factory=list)
    sink: Optional[object] = None   # telemetry.MetricsSink (optional)

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step was a straggler.  The first 6 steps
        only feed the EWMA (warm-up steps would flag everything after).
        With a ``sink`` every straggler also emits a ``straggler_dt_s``
        sample (the engine streams every step's latency separately; this
        series carries only the outliers the EWMA flagged)."""
        is_straggler = self.n > 5 and dt > self.threshold * self.ewma
        self.ewma = dt if self.n == 0 else \
            (1 - self.ewma_alpha) * self.ewma + self.ewma_alpha * dt
        self.n += 1
        if is_straggler:
            self.stragglers += 1
            self.log.append({"step": step, "dt": dt, "ewma": self.ewma})
            if self.sink is not None:
                self.sink.observe("straggler_dt_s", dt, step)
        return is_straggler


class Heartbeat:
    def __init__(self, path: str | Path, every_s: float = 30.0,
                 sink: Optional[object] = None):
        self.path = Path(path)
        self.every_s = every_s
        self.sink = sink        # telemetry.MetricsSink: a `heartbeat` series
        self._last = 0.0
        self.beats = 0

    def beat(self, step: int) -> bool:
        """Write the liveness marker if due; returns True when written."""
        now = time.time()
        if now - self._last < self.every_s:
            return False
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps({"step": step, "t": now}))
        self._last = now
        self.beats += 1
        if self.sink is not None:
            self.sink.observe("heartbeat", self.beats, step)
        return True
