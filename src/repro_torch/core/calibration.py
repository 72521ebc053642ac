"""Model-wide TD-VMM calibration state (torch port of
``repro.core.calibration``).

The §3.1 output-window calibration is **model state**: each site's readout
window is captured once on a representative batch and then pinned for
serving, where it skips the per-call max|z| reduction and lets the kernel
fuse the whole epilogue (a fixed window is tile-local).

Capture protocol: ``collect()`` installs a collector; ``core.layers``
records each enabled digital-boundary site's latch-normalized max|z| with
``record``.  The JAX package records through ``jax.debug.callback`` because
its layer stacks are traced scans; the port runs eagerly, max-merges on the
tensors' device and reads every site back once, when ``collect`` exits.

Two serving-time mechanisms ride the same per-site channel:

  * **Runtime windows** (``runtime_windows``): site -> window tensors that
    ``core.layers`` reads as operands — the serving engine's channel, whose
    tensors ``runtime.engine.Engine.set_calibration`` updates in place.
  * **Clip tracking** (``collect(pinned=...)``): a capture pass given the
    pinned windows also tallies, per site, how many latch-normalized |z|
    elements exceed the pinned window — the readout clip rate that drift
    detection (``models.model.drift_probe`` ->
    ``runtime.engine.DriftConfig``) thresholds.  The tallies are counted
    on the device during the pass and read once at exit, as exact
    ``(exceed, total)`` float64 pairs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TDVMMPlan, tdvmm_rule


@dataclasses.dataclass
class CalibrationState:
    """Per-site calibrated readout windows.

    windows: site name -> float32 CPU tensor; shape ``()`` for plain sites,
    ``(E,)`` for expert-batched sites.
    """
    windows: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def sites(self) -> tuple[str, ...]:
        return tuple(sorted(self.windows))

    @classmethod
    def from_collected(cls, collected: dict[str, np.ndarray],
                       floor: float = 1e-9) -> "CalibrationState":
        return cls(windows={
            site: torch.from_numpy(np.asarray(np.maximum(
                np.asarray(v, np.float32), np.float32(floor))))
            for site, v in sorted(collected.items())})

    def as_arrays(self, device=None) -> dict[str, torch.Tensor]:
        """Site -> float32 window tensor on ``device`` (the runtime-operand
        form the serving engine passes to its two step functions)."""
        return {site: torch.as_tensor(v, dtype=torch.float32).to(device)
                for site, v in sorted(self.windows.items())}

    def drift_ratios(self, fresh: "CalibrationState") -> dict[str, float]:
        """Per-site fresh/pinned window ratio, the element furthest from 1
        either way (in |log|) — the drift magnitude a recalibration
        decision thresholds.  > 1: the live max|z| outgrew the pinned
        window (the readout clips); < 1: the window is oversized
        (resolution loss)."""
        out = {}
        for site, pinned in self.windows.items():
            if site not in fresh.windows:
                continue
            p = np.maximum(_host64(pinned), 1e-12)
            f = _host64(fresh.windows[site])
            if p.shape != f.shape:
                raise ValueError(
                    f"site {site!r}: pinned window shape {p.shape} vs "
                    f"recaptured {f.shape} — calibration structure changed")
            r = f / p
            out[site] = float(r.flat[np.argmax(np.abs(np.log(
                np.maximum(r, 1e-12))))])
        return out


def _host64(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float64)


# ---------------------------------------------------------------------------
# Collector (capture-time side channel)
# ---------------------------------------------------------------------------
class _Collector(threading.local):
    def __init__(self):
        self.store: Optional[dict] = None
        self.pinned: Optional[dict[str, torch.Tensor]] = None
        self.clips: Optional[dict] = None


_COLLECTOR = _Collector()


def active() -> bool:
    """True while a ``collect()`` context is installed."""
    return _COLLECTOR.store is not None


def clip_reference(site: str) -> Optional[torch.Tensor]:
    """The pinned window the active collector tallies clips against for
    ``site`` (None when no clip tracking is requested)."""
    pinned = _COLLECTOR.pinned
    if pinned is None or not site:
        return None
    return pinned.get(site)


def record(site: str, z_max: torch.Tensor) -> None:
    """Max-merge one site's latch-normalized |z| maximum (scalar or (E,))
    into the active collector, on the tensor's device.  No-op without a
    collector."""
    store = _COLLECTOR.store
    if store is None or not site:
        return
    value = z_max.detach().to(torch.float32)
    prev = store.get(site)
    store[site] = value if prev is None else torch.maximum(prev, value)


def record_clip(site: str, exceed: torch.Tensor, total: int) -> None:
    """Accumulate one site's (clipped-element count, element count) tally
    against the collector's pinned window; ``exceed`` stays on its device
    until ``collect`` exits.  No-op unless ``collect(pinned=...)``
    installed clip tracking."""
    clips = _COLLECTOR.clips
    if clips is None or not site:
        return
    prev = clips.get(site)
    clips[site] = (exceed, total) if prev is None else \
        (prev[0] + exceed, prev[1] + total)


def clip_rates(clips: dict[str, np.ndarray]) -> dict[str, float]:
    """(exceed, total) tallies -> per-site clip fraction in [0, 1]."""
    return {site: float(v[0] / max(v[1], 1.0)) for site, v in clips.items()}


def clip_rate_metrics(rates: dict[str, float]) -> dict[str, float]:
    """Per-site clip rates as metric series names (``clip_rate.<site>``),
    in sorted site order so an observation sequence is deterministic."""
    return {f"clip_rate.{site}": float(v)
            for site, v in sorted(rates.items())}


@contextlib.contextmanager
def collect(pinned: Optional[dict[str, torch.Tensor]] = None,
            ) -> Iterator[dict[str, np.ndarray]]:
    """Install a collector; yields the site -> max|z| dict, whose values
    are float32 numpy arrays once the context exits.

    With ``pinned`` (site -> window tensors, on the device the pass runs
    on), the pass also tallies per-site clip counts against those windows;
    read them from ``last_clips()`` after the context exits (or use
    ``models.model.drift_probe``, which returns both)."""
    if _COLLECTOR.store is not None:
        raise RuntimeError("nested calibration collect() is not supported")
    store: dict = {}
    _COLLECTOR.store = store
    _COLLECTOR.clips = {} if pinned is not None else None
    _COLLECTOR.pinned = None if pinned is None else {
        site: torch.as_tensor(v, dtype=torch.float32)
        for site, v in pinned.items()}
    clips = _COLLECTOR.clips
    _LAST_CLIPS[0] = None
    try:
        yield store
        # one read-back for the whole pass
        for site, v in store.items():
            store[site] = v.cpu().numpy()
        if clips is not None:
            exceed = torch.stack([torch.as_tensor(c[0]).reshape(())
                                  .to(torch.float64)
                                  for c in clips.values()]).cpu().numpy() \
                if clips else []
            _LAST_CLIPS[0] = {
                site: np.asarray([e, float(c[1])], np.float64)
                for (site, c), e in zip(clips.items(), exceed)}
    finally:
        _COLLECTOR.store = None
        _COLLECTOR.pinned = None
        _COLLECTOR.clips = None


_LAST_CLIPS: list = [None]


def last_clips() -> Optional[dict[str, np.ndarray]]:
    """(exceed, total) float64 tallies from the most recent
    ``collect(pinned=...)`` pass (None when the last pass did not track
    clips)."""
    return _LAST_CLIPS[0]


# ---------------------------------------------------------------------------
# Runtime windows (serving calibration as operands)
# ---------------------------------------------------------------------------
class _RuntimeWindows(threading.local):
    def __init__(self):
        self.map: Optional[dict[str, torch.Tensor]] = None


_RUNTIME = _RuntimeWindows()


@contextlib.contextmanager
def runtime_windows(windows: Optional[dict[str, torch.Tensor]]):
    """Install site -> float32 window tensors for the duration of a step.

    Inside the context every TD-VMM site whose name appears in the map takes
    its readout window from the tensor instead of the plan's ``out_scale``
    (same arithmetic, bit for bit).  ``None``/empty maps are a no-op."""
    prev = _RUNTIME.map
    _RUNTIME.map = dict(windows) if windows else prev
    try:
        yield
    finally:
        _RUNTIME.map = prev


def runtime_window_map() -> Optional[dict[str, torch.Tensor]]:
    """The full site -> window map currently installed (None outside a
    ``runtime_windows`` context)."""
    return _RUNTIME.map


def runtime_window(site: str) -> Optional[torch.Tensor]:
    """The runtime window installed for ``site`` (None outside a
    ``runtime_windows`` context or for uncovered sites)."""
    m = _RUNTIME.map
    if m is None or not site:
        return None
    return m.get(site)


# ---------------------------------------------------------------------------
# Applying captured state to a model config
# ---------------------------------------------------------------------------
def _host_window(value) -> float | tuple[float, ...]:
    arr = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) \
        else np.asarray(value)
    if arr.ndim == 0:
        return float(arr)
    if arr.ndim == 1:
        return tuple(float(v) for v in arr)
    raise ValueError(f"calibration window must be scalar or (E,), "
                     f"got shape {arr.shape}")


def apply_calibration(cfg: ModelConfig,
                      calib: Optional[CalibrationState]) -> ModelConfig:
    """Bake a CalibrationState into the model's plan: each captured window
    becomes an appended exact-site rule setting ``out_scale`` (later rules
    win, so calibration overrides any statically configured window)."""
    if calib is None or not calib.windows:
        return cfg
    from repro_torch.configs.plan import GROUPED_SITES
    plan = cfg.tdvmm_plan if cfg.tdvmm_plan is not None else TDVMMPlan()
    rules = []
    for site in sorted(calib.windows):
        window = _host_window(calib.windows[site])
        members = GROUPED_SITES.get(site)
        if members and isinstance(window, tuple) and len(window) != len(members):
            raise ValueError(
                f"grouped site {site!r}: calibration captured "
                f"{len(window)} windows for the {len(members)}-member "
                f"launch {members}")
        rules.append(tdvmm_rule(site, out_scale=window))
    return cfg.replace(tdvmm_plan=plan.with_rules(*rules))
