"""Model-wide TD-VMM calibration state (torch port of
``repro.core.calibration``, serving subset).

The §3.1 output-window calibration is **model state**: each site's readout
window is captured once on a representative batch and then pinned for
serving, where it skips the per-call max|z| reduction and lets the kernel
fuse the whole epilogue (a fixed window is tile-local).

Capture protocol: ``collect()`` installs a collector; ``core.layers``
records each enabled digital-boundary site's latch-normalized max|z| with
``record``.  The JAX package records through ``jax.debug.callback`` because
its layer stacks are traced scans; the port runs eagerly and max-merges
directly.  ``runtime_windows`` installs site -> window tensors that
``core.layers`` reads as runtime operands (the serving engine's channel).
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


# ---------------------------------------------------------------------------
# Collector (capture-time side channel)
# ---------------------------------------------------------------------------
class _Collector(threading.local):
    def __init__(self):
        self.store: Optional[dict[str, np.ndarray]] = None


_COLLECTOR = _Collector()


def active() -> bool:
    """True while a ``collect()`` context is installed."""
    return _COLLECTOR.store is not None


def record(site: str, z_max: torch.Tensor) -> None:
    """Max-merge one site's latch-normalized |z| maximum (scalar or (E,))
    into the active collector.  No-op without a collector."""
    store = _COLLECTOR.store
    if store is None or not site:
        return
    value = z_max.detach().to("cpu", torch.float32).numpy()
    prev = store.get(site)
    store[site] = value if prev is None else np.maximum(prev, value)


@contextlib.contextmanager
def collect() -> Iterator[dict[str, np.ndarray]]:
    """Install a collector; yields the (mutating) site -> max|z| dict."""
    if _COLLECTOR.store is not None:
        raise RuntimeError("nested calibration collect() is not supported")
    _COLLECTOR.store = {}
    try:
        yield _COLLECTOR.store
    finally:
        _COLLECTOR.store = None


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
