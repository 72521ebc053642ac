"""Deterministic fault injection for the serving engine — torch port of
``repro.runtime.faultinject``.

The engine's fault contracts — killed at any step, it resumes its ragged
trace with the same streams; a persistently failing step degrades to one
``failed`` request with its neighbours' streams unchanged; drifted device
currents trigger an online recalibration without a third step program —
need faults that fire at an exact engine step, the same way every run.
Events are scheduled by step number and consumed by
``runtime.engine.Engine`` through ``FaultConfig.injector``:

  * :class:`FailStep` — raise :class:`FaultError` when the engine is about
    to run step kind ``kind`` at engine step ``step``, ``times`` raises in
    all.  ``times <= retries`` is a transient failure (``fault.retry_step``
    recovers it, streams unchanged); more is a persistent one (the engine
    finishes the culprit request ``failed`` and keeps serving).  The raise
    comes *before* the step function runs, so a failed attempt writes
    nothing to the page pools.
  * :class:`PreemptAt` — flip the run's preemption flag at step ``step``:
    the engine snapshots and exits as if SIGTERM landed between steps.
  * :class:`DriftAt` — perturb the engine's weight matrices with
    ``core.nonideal.perturb_currents`` at step ``step`` (the FG-cell tuning
    drift of section 4.1): every TD-VMM site's max|z| moves, and the drift
    probe's clip rates against the pinned windows go stale.
  * :class:`SlowStep` — sleep ``sleep_s`` inside the step wrapper at
    engine step ``step``: one tick's wall time inflates, once.

Randomness comes from explicit seeds (a ``torch.Generator`` on the
parameters' device); the draws are not the JAX package's ``jax.random``
bits.  Nothing here reads clocks.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.core.constants import TDVMMSpec
from repro_torch.core.nonideal import NonIdealityConfig, perturb_currents
from repro_torch.tree import leaves

__all__ = ["FaultError", "FailStep", "PreemptAt", "DriftAt", "SlowStep",
           "FaultInjector", "drift_params"]


class FaultError(RuntimeError):
    """Injected step failure.  A RuntimeError on purpose: that is what
    ``fault.retry_step`` retries, so injected faults take the real retry
    path.  ``rid`` names the request whose work the failing step was doing
    (None: the engine blames the oldest runnable slot)."""

    def __init__(self, message: str, rid: Optional[int] = None):
        super().__init__(message)
        self.rid = rid


@dataclasses.dataclass
class FailStep:
    """Raise on step kind ``kind`` at engine step ``step``, ``times`` raises
    in all (consumed across retry attempts)."""
    step: int
    kind: str = "decode"            # "prefill" | "decode" | "any"
    times: int = 1
    rid: Optional[int] = None       # blame this request (None = oldest)
    message: str = "injected step failure"
    fired: int = 0                  # raises consumed so far

    def matches(self, kind: str, step: int) -> bool:
        return (self.fired < self.times and step == self.step
                and self.kind in (kind, "any"))


@dataclasses.dataclass
class PreemptAt:
    """Request preemption once the engine reaches ``step`` (between
    steps)."""
    step: int
    fired: bool = False


@dataclasses.dataclass
class DriftAt:
    """Perturb the engine's weights at ``step``: lognormal FG tuning error
    of relative width ``sigma``, applied ``repeats`` times (compounding)."""
    step: int
    sigma: float = 0.05
    seed: int = 0
    repeats: int = 1
    fired: bool = False


@dataclasses.dataclass
class SlowStep:
    """Sleep ``sleep_s`` before step kind ``kind`` at engine step ``step``
    — a one-step straggler.  The step itself is untouched, so the streams
    are those of a run without the event."""
    step: int
    sleep_s: float = 0.25
    kind: str = "any"               # "prefill" | "decode" | "any"
    fired: bool = False

    def matches(self, kind: str, step: int) -> bool:
        return (not self.fired and step == self.step
                and self.kind in (kind, "any"))


class FaultInjector:
    """Deterministic event schedule consumed by ``Engine._drive``.

    ``on_tick(engine, step)`` runs between steps (preemption and drift);
    ``check(kind, step)`` runs inside the retry wrapper just before each
    step function (failures and stragglers)."""

    def __init__(self, events):
        self.events = list(events)

    def on_tick(self, engine, step: int) -> None:
        for ev in self.events:
            if isinstance(ev, PreemptAt) and not ev.fired and step >= ev.step:
                ev.fired = True
                engine.request_preemption()
            elif isinstance(ev, DriftAt) and not ev.fired and step >= ev.step:
                ev.fired = True
                engine.params = drift_params(
                    engine.params, ev.seed, _model_spec(engine.cfg),
                    NonIdealityConfig(dibl=False, weight_noise=True,
                                      sigma_tune=ev.sigma),
                    repeats=ev.repeats)

    def check(self, kind: str, step: int) -> None:
        for ev in self.events:
            if isinstance(ev, FailStep) and ev.matches(kind, step):
                ev.fired += 1
                raise FaultError(
                    f"{ev.message} (kind={kind}, step={step}, "
                    f"raise {ev.fired}/{ev.times})", rid=ev.rid)
            if isinstance(ev, SlowStep) and ev.matches(kind, step):
                ev.fired = True
                time.sleep(ev.sleep_s)

    def report(self) -> list[dict]:
        """Each event's fields as a dict, its class name under "event"."""
        out = []
        for ev in self.events:
            d = dataclasses.asdict(ev)
            d["event"] = type(ev).__name__
            out.append(d)
        return out


def _model_spec(cfg) -> TDVMMSpec:
    """The TDVMMSpec drift perturbations are priced against: any enabled
    site's spec (they share the paper's operating point by default)."""
    for _, sc in cfg.resolved_tdvmm_plan.sites:
        if sc.enabled:
            return sc.spec
    return TDVMMSpec()


def _drifted(tree, gen: torch.Generator, spec: TDVMMSpec,
             nicfg: NonIdealityConfig, repeats: int, min_dim: int):
    if isinstance(tree, dict):
        return {k: _drifted(v, gen, spec, nicfg, repeats, min_dim)
                for k, v in tree.items()}
    if isinstance(tree, list):
        # a segment's per-layer dicts: the JAX package stacks them along a
        # leading layer axis, so a per-layer vector counts as a matrix there
        return [_drifted(v, gen, spec, nicfg, repeats, 1) for v in tree]
    if (not isinstance(tree, torch.Tensor) or tree.dim() < min_dim
            or not tree.is_floating_point()):
        return tree
    leaf = tree.to(torch.float32)
    for _ in range(repeats):
        leaf = perturb_currents(leaf, gen, spec, nicfg)
    return leaf.to(tree.dtype)


def drift_params(params, seed: int, spec: TDVMMSpec,
                 nicfg: NonIdealityConfig, subtree: str = "blocks",
                 repeats: int = 1):
    """Apply device-current drift to every weight matrix under
    ``params[subtree]`` — the leaves the JAX package's ``drift_params``
    perturbs (float, two or more dims in its stacked layout), each by
    ``nonideal.perturb_currents`` in float32, ``repeats`` times, then cast
    back.  One ``torch.Generator`` on the parameters' device, seeded with
    ``seed``, draws for the leaves in order.  Returns a new parameter dict
    (the input is untouched)."""
    target = params[subtree]
    gen = torch.Generator(device=leaves(target)[0].device)
    gen.manual_seed(seed)
    new = dict(params)
    new[subtree] = _drifted(target, gen, spec, nicfg, repeats, 2)
    return new

