"""Streaming telemetry for the serving engine — the port's copy of
``repro.runtime.telemetry`` (pure Python): metrics sink, rolling robust
statistics, and online regression/spike detection.

The engine's drive loop feeds a :class:`MetricsSink` every tick — step
latency, queue depth, tokens, fJ/Op, page pressure, retry/straggler/drift
counters — and the sink evaluates *alert rules* online:

  * **spike**: value exceeds the rolling **median + k·MAD** of the metric's
    recent window (robust to the occasional outlier in the window itself —
    a mean/stddev detector would be blinded by the very spikes it should
    catch).  ``abs_floor``/``rel_floor`` add a deadband so a near-zero MAD
    on a quiet series can't turn measurement jitter into alerts.
  * **threshold**: value exceeds a fixed limit.
  * **regression**: value exceeds ``baseline * (1 + tol)`` — e.g. fJ/Op
    drifting above the calibrated baseline while serving.

Every per-tick cost is **O(1) in the stream length**: series history lives
in a fixed-capacity ring, and the rolling median/MAD window is a fixed
constant ``window`` (a bisect-maintained sorted snapshot of the last
``window`` values).  The float arithmetic and its order are the JAX
package's, so the same samples give equal statistics and alert decisions.

Emitters are pluggable observers (in-memory for tests, JSONL for
``launch/serve.py --metrics-jsonl``, stdout for humans).  The sink's
dynamic state is a plain-JSON ``snapshot()``/``restore()`` payload that
rides inside ``Engine.snapshot()``'s meta leaf, so a killed engine restored
in a fresh process continues its series and alert history where they
stopped.

Statistics are host-side floats between the two step programs: the sink
reads host integers and floats only, never a device tensor, so it adds no
device sync and no third step shape (``step_shapes == 2`` holds through any
sink-wired run).
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
from collections import deque
from pathlib import Path
from typing import Optional

__all__ = ["Alert", "AlertRule", "RollingSeries", "MetricsSink",
           "MemoryEmitter", "JsonlEmitter", "StdoutEmitter"]


@dataclasses.dataclass(frozen=True)
class Alert:
    """One fired alert: which rule, on what value, against what stats."""
    step: int
    metric: str
    kind: str                    # "spike" | "threshold" | "regression"
    value: float
    limit: float                 # the bound the value crossed
    median: float = 0.0          # rolling stats at evaluation time (spike)
    mad: float = 0.0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """Declarative alert condition on one metric.

    spike:      value > median + max(k * MAD, rel_floor * median, abs_floor)
                evaluated against the window *before* the new value (a spike
                never suppresses itself), only once >= min_samples exist.
    threshold:  value > limit.
    regression: value > baseline * (1 + tol).
    """
    metric: str
    kind: str = "spike"
    k: float = 6.0               # MAD multiplier (spike)
    min_samples: int = 8         # prior samples required before spike eval
    abs_floor: float = 0.0       # spike deadband, absolute
    rel_floor: float = 0.0       # spike deadband, fraction of the median
    limit: Optional[float] = None      # threshold bound
    baseline: Optional[float] = None   # regression reference
    tol: float = 0.1                   # regression tolerance fraction

    def __post_init__(self):
        if self.kind not in ("spike", "threshold", "regression"):
            raise ValueError(f"unknown alert kind {self.kind!r}")
        if self.kind == "threshold" and self.limit is None:
            raise ValueError(f"threshold rule on {self.metric!r} needs limit=")
        if self.kind == "regression" and self.baseline is None:
            raise ValueError(
                f"regression rule on {self.metric!r} needs baseline=")

    def evaluate(self, value: float, median: float, mad: float,
                 n_prior: int, step: int) -> Optional[Alert]:
        if self.kind == "threshold":
            if value > self.limit:
                return Alert(step=step, metric=self.metric, kind=self.kind,
                             value=float(value), limit=float(self.limit))
            return None
        if self.kind == "regression":
            bound = self.baseline * (1.0 + self.tol)
            if value > bound:
                return Alert(step=step, metric=self.metric, kind=self.kind,
                             value=float(value), limit=float(bound))
            return None
        # spike
        if n_prior < self.min_samples:
            return None
        band = max(self.k * mad, self.rel_floor * median, self.abs_floor)
        bound = median + band
        if value > bound:
            return Alert(step=step, metric=self.metric, kind=self.kind,
                         value=float(value), limit=float(bound),
                         median=float(median), mad=float(mad))
        return None


class RollingSeries:
    """Ring-buffered series with a constant-size rolling median/MAD window.

    ``capacity`` bounds the retained history (old samples fall off the
    ring); ``window`` is the rolling-statistics span.  A bisect-maintained
    sorted copy of the window makes the median an O(1) lookup and every
    push O(window) — constant per tick, independent of stream length.
    """

    def __init__(self, capacity: int = 512, window: int = 32):
        if capacity < 1 or window < 1:
            raise ValueError(f"capacity/window must be >= 1, got "
                             f"{capacity}/{window}")
        self.capacity = capacity
        self.window = window
        self.values: deque[float] = deque(maxlen=capacity)
        self.steps: deque[int] = deque(maxlen=capacity)
        self.count = 0                       # lifetime pushes (survives ring)
        self._win: deque[float] = deque()    # last `window` values, FIFO
        self._sorted: list[float] = []       # same values, sorted

    def push(self, step: int, value: float) -> None:
        value = float(value)
        self.values.append(value)
        self.steps.append(int(step))
        self.count += 1
        self._win.append(value)
        bisect.insort(self._sorted, value)
        if len(self._win) > self.window:
            old = self._win.popleft()
            del self._sorted[bisect.bisect_left(self._sorted, old)]

    @property
    def last(self) -> Optional[float]:
        return self.values[-1] if self.values else None

    def median(self) -> float:
        s = self._sorted
        if not s:
            return 0.0
        m = len(s) // 2
        return s[m] if len(s) % 2 else 0.5 * (s[m - 1] + s[m])

    def mad(self) -> float:
        """Median absolute deviation of the rolling window (O(window))."""
        s = self._sorted
        if not s:
            return 0.0
        med = self.median()
        devs = sorted(abs(x - med) for x in s)
        m = len(devs) // 2
        return devs[m] if len(devs) % 2 else 0.5 * (devs[m - 1] + devs[m])

    def state_dict(self) -> dict:
        return {"values": list(self.values), "steps": list(self.steps),
                "count": self.count, "win": list(self._win)}

    def load_state_dict(self, state: dict) -> None:
        self.values = deque((float(v) for v in state["values"]),
                            maxlen=self.capacity)
        self.steps = deque((int(s) for s in state["steps"]),
                           maxlen=self.capacity)
        self.count = int(state["count"])
        self._win = deque(float(v) for v in state["win"])
        self._sorted = sorted(self._win)


# --------------------------------------------------------------------------
# Emitters
# --------------------------------------------------------------------------
class MemoryEmitter:
    """Collects everything in lists — the test/inspection emitter."""

    def __init__(self):
        self.metrics: list[tuple[str, int, float]] = []
        self.alerts: list[Alert] = []

    def on_metric(self, metric: str, step: int, value: float) -> None:
        self.metrics.append((metric, step, value))

    def on_alert(self, alert: Alert) -> None:
        self.alerts.append(alert)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class JsonlEmitter:
    """Appends one JSON object per metric sample / alert to a file — the
    ``launch/serve.py --metrics-jsonl`` sink, greppable and artifactable."""

    def __init__(self, path):
        self.path = Path(path)
        self._fh = None

    def _handle(self):
        if self._fh is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a")
        return self._fh

    def on_metric(self, metric: str, step: int, value: float) -> None:
        self._handle().write(json.dumps(
            {"t": "metric", "metric": metric, "step": step,
             "value": value}) + "\n")

    def on_alert(self, alert: Alert) -> None:
        fh = self._handle()
        fh.write(json.dumps({"t": "alert", **alert.to_json()}) + "\n")
        fh.flush()                       # alerts are worth a flush

    def flush(self) -> None:
        """Durability point: flush + fsync so the last tick's metrics
        survive a SIGKILL right after a preemption snapshot (the engine
        calls this from ``report()`` and from the snapshot-and-exit
        path)."""
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class StdoutEmitter:
    """Prints alerts (metrics would spam a terminal at one tick each)."""

    def __init__(self, prefix: str = "[telemetry]"):
        self.prefix = prefix

    def on_metric(self, metric: str, step: int, value: float) -> None:
        pass

    def on_alert(self, alert: Alert) -> None:
        print(f"{self.prefix} ALERT {alert.kind} {alert.metric} "
              f"step={alert.step}: value {alert.value:.4g} > "
              f"limit {alert.limit:.4g}")

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


# --------------------------------------------------------------------------
# The sink
# --------------------------------------------------------------------------
class MetricsSink:
    """Streaming metrics hub: per-metric rolling series + online alert
    evaluation + fan-out to emitters.

    ``observe`` is the single entry point (the engine calls it every tick;
    ``fault.StragglerMonitor``/``Heartbeat`` call it on their events).
    Rules evaluate against the window state *before* the new value lands,
    so one spike cannot raise the bound that should catch it.
    """

    def __init__(self, rules=(), window: int = 32, capacity: int = 512,
                 emitters=()):
        self.window = window
        self.capacity = capacity
        self.rules: list[AlertRule] = list(rules)
        self.emitters = list(emitters)
        self.series: dict[str, RollingSeries] = {}
        self.alerts: list[Alert] = []
        self.observations = 0

    def _series(self, metric: str) -> RollingSeries:
        s = self.series.get(metric)
        if s is None:
            s = self.series[metric] = RollingSeries(self.capacity,
                                                    self.window)
        return s

    def observe(self, metric: str, value: float, step: int) -> list[Alert]:
        """Record one sample; returns any alerts it fired."""
        value = float(value)
        s = self._series(metric)
        fired = []
        median, mad, n_prior = s.median(), s.mad(), s.count
        for rule in self.rules:
            if rule.metric != metric:
                continue
            alert = rule.evaluate(value, median, mad, n_prior, step)
            if alert is not None:
                fired.append(alert)
        s.push(step, value)
        self.observations += 1
        for em in self.emitters:
            em.on_metric(metric, step, value)
        for alert in fired:
            self.alerts.append(alert)
            for em in self.emitters:
                em.on_alert(alert)
        return fired

    def flush(self) -> None:
        """Push buffered emitter output to durable storage (fsync for
        ``JsonlEmitter``).  Called by the engine on every ``report()`` and
        on the preemption snapshot-and-exit path, so the final tick's
        metrics are never lost to a buffered file handle on SIGTERM."""
        for em in self.emitters:
            fn = getattr(em, "flush", None)
            if fn is not None:
                fn()

    def alerts_for(self, metric: str, kind: Optional[str] = None
                   ) -> list[Alert]:
        return [a for a in self.alerts if a.metric == metric
                and (kind is None or a.kind == kind)]

    def summary(self) -> dict:
        """Aggregate view for reports: per-metric rolling stats + alert
        counts by (metric, kind)."""
        by_kind: dict[str, int] = {}
        for a in self.alerts:
            key = f"{a.metric}:{a.kind}"
            by_kind[key] = by_kind.get(key, 0) + 1
        return {
            "observations": self.observations,
            "alerts": len(self.alerts),
            "alerts_by_rule": by_kind,
            "metrics": {
                name: {"count": s.count, "last": s.last,
                       "median": s.median(), "mad": s.mad()}
                for name, s in self.series.items()},
        }

    # ------------------------------------------------------------------
    # Snapshot / restore (rides in Engine.snapshot()'s meta leaf)
    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """Dynamic state as plain JSON.  Rules/emitters are *configuration*
        (the restoring process constructs the sink the same way it
        constructs the engine) — only series, alerts, and counters ride."""
        return {
            "version": 1,
            "observations": self.observations,
            "series": {name: s.state_dict()
                       for name, s in self.series.items()},
            "alerts": [a.to_json() for a in self.alerts],
        }

    def restore(self, snap: dict) -> None:
        if not isinstance(snap, dict) or "series" not in snap:
            raise ValueError("not a MetricsSink snapshot")
        self.observations = int(snap["observations"])
        self.series = {}
        for name, state in snap["series"].items():
            self._series(name).load_state_dict(state)
        self.alerts = [Alert(**a) for a in snap["alerts"]]
