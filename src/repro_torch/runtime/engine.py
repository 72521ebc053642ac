"""Continuous-batching TD-VMM serving engine — torch port of
``repro.runtime.engine`` (its fault tolerance and drift recalibration, SLA
policy, streaming telemetry, request tracing and mesh mode).

The paper's system discipline — fixed conversion circuitry, time-multiplexed
inputs — maps onto serving as two fixed-shape step functions (a chunked
prefill step of shape (1, C) and a batched decode step of shape (B, 1)) that
a ragged request stream is multiplexed through:

  * a fixed pool of B decode **slots**, admitted FIFO by arrival
    (``runtime/scheduler.py``), or by priority with aging under an SLA
    policy (``runtime/sla.py``);
  * a **paged** KV cache: attention KV lives in fixed-size pages owned per
    request via block tables (``runtime/paged_cache.py``), updated in place
    (int8 codes with per-(token, head) scales under
    ``models.attention.set_kv_cache_int8``);
  * **chunked prefill**: prompts are absorbed ``chunk`` tokens per step,
    interleaved with decode.

The pinned ``CalibrationState`` enters both steps as a site -> window dict
of device tensors (``core.calibration.runtime_windows``), read by the
TD-VMM kernels as operands.  The engine requires pinned windows on every
enabled digital-boundary site: a per-call data-calibrated window is a max
over the whole batch and would couple requests.  In exchange every
request's token stream equals the same request served alone.

MoE models (no sliding window) serve through the same two steps, and so
does their capacity dispatch (``models.moe``), as in the JAX package: an
expert buffer holds ``max(int(T * top_k * factor / E) + 1, 4)`` rows for a
step of T tokens, and rows past it drop.  A prefill chunk holds one slot,
and its padded rows sort after its real rows within each expert, so they
never take a real token's place: a chunk's drops depend on that chunk
alone.  A decode step of B slots puts at most B rows on an expert, so it
cannot drop while B <= capacity(B) (up to 4 slots at the published factor
1.25, E 384 and top-8, and in the smoke config, E 4 and top-2).  Above
that, drops couple the slots of a decode step, in the JAX package's engine
too: batched == solo holds only where no decode step can drop.

Request lifecycle::

    pending --admit(slot+pages)--> prefilling --last chunk--> decoding
       |                                                         |
       +--> evicted (prompt exceeds page budget)                 +--> eos
       +--> rejected (SLA admission: deadline- or                +--> max_tokens
            joule-infeasible, before any compute)                +--> evicted
                                                                 +--> failed
                                                                 +--> over_budget
                                                   (evicted: page budget
                                                    exhausted — finished
                                                    BEFORE the overflowing
                                                    write; failed: a
                                                    persistently failing
                                                    step, blamed on one
                                                    request so the engine
                                                    keeps serving;
                                                    over_budget: joule
                                                    budget crossed
                                                    mid-stream under an
                                                    SLA policy)

Fault tolerance (``FaultConfig``): a ``fault.PreemptionGuard`` (or an
injected ``faultinject.PreemptAt``) unwinds the run between steps to a
**snapshot** — the whole in-flight state (scheduler queue, slots, block
tables, the page pool's free list, the page pools, emitted tokens, energy
accounting, the pinned windows) — and ``restore`` + ``resume`` replays the
rest of the trace to the same streams as an unbroken run.
``fault.retry_step`` wraps both steps: a transient failure is retried
invisibly, a persistent one finishes one request ``failed`` with its
neighbours' streams unchanged.  A retried step rewrites the same page
positions with the same values a failed attempt may have written part of,
so a retry is idempotent.  A kernel launch that returns a CUDA error and a
CUDA error that leaves the context unusable (an illegal address, a
device-side assert) are never retried, they end the run as a
``DeviceFault``; a kernel that cannot be built ends it as
``kernels._build.BuildError``.  ``DriftConfig`` probes the windows every few
steps (``models.model.drift_probe``) and, when they have drifted, copies a
fresh capture into the same window tensors the steps read: the step
programs stay two.

Energy: every processed token is priced by the resolved plan's analog-tile
geometry (``core.energy.serving_energy_model``) into per-request Op counts
and joules — the paper's fJ/Op, measured at request level.  Every report
carries ``site_attribution``, whose per-site table sums bit-exactly to the
aggregate ``analog_ops``/``analog_energy_j``/``fj_per_op``.

SLA, telemetry and tracing: ``sla=`` (``runtime.sla.SlaConfig``) schedules
with priority-with-aging admission, rejects deadline- and joule-infeasible
requests at admission (no slot, no page, no step) and finishes a request
that crosses its joule budget mid-stream ``over_budget``; ``sink=``
(``runtime.telemetry.MetricsSink``) streams per-tick series (step latency,
queue depth, slots, pages, tokens, retries, fJ/Op) with online alert rules,
and with ``DriftConfig.observe_every`` the per-site readout clip rates as
``clip_rate.<site>`` series; ``tracer=`` (``runtime.trace.Tracer``) records
the request lifecycle as Chrome-trace spans on a cumulative engine clock.
All three read host integers and floats only, between the two step programs
(no device sync, no third step shape: ``step_shapes == 2``), their state
rides ``snapshot()``, and with all three off every trace replays as before.
A tick is timed on the host clock; on the card that is host wall time,
including whatever device wait the tick absorbed (``runtime.trace``).

Mesh mode (``mesh=``, a ``DeviceMesh`` with axes ``data`` x ``model``; one
process per device, every rank constructing the same Engine and running
the same trace): the engine takes the full params and keeps this rank's
shards of the training rules' TP layout, replicated over DP (no ZeRO
gathers in a step), with expert banks split over the data axes under
``moe.impl='ep'`` (``launch.sharding.param_specs(..., dp_axes=(),
ep_axes=dp)``); its page pools hold this rank's KV heads
(``sharding.paged_specs``), with the page dim whole.  The DP axes multiply
the slot pool: ``total_slots = dp * ecfg.slots``, slot id ``dp_rank *
ecfg.slots + local_slot``, one page region per rank
(``PagePool(ranks=dp)``).  Every rank runs the same host scheduler on the
same inputs.  A prefill chunk (one slot) runs on every rank alike; a decode
step runs each rank's own rows, and the sampled tokens are all-gathered
over the data axes so every rank's scheduler agrees.  There are still two
step programs per rank.  A snapshot gathers full page pools (each rank's
region from its owner, the heads over ``model``) and carries ``dp``; it
restores onto an engine of the same ``dp``.  A (1, 1) mesh is bitwise no
mesh.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import energy as energy_model
from repro_torch.core.calibration import (CalibrationState, apply_calibration,
                                          clip_rate_metrics)
from repro_torch.kernels import _build
from repro_torch.kernels.tdvmm import ops as tdvmm_ops
from repro_torch.kernels.tdvmm import tdvmm
from repro_torch.launch import meshctx
from repro_torch.launch import sharding as shardlib
from repro_torch.models import model
from repro_torch.runtime import fault
from repro_torch.runtime import sla as sla_policy
from repro_torch.runtime.paged_cache import PagePool, pages_for
from repro_torch.runtime.scheduler import (Request, RequestRecord, Slot,
                                           SlotScheduler, static_baseline)
from repro_torch.runtime.trace import span
from repro_torch.tree import leaves_with_paths, tree_map

__all__ = ["Engine", "EngineConfig", "EngineReport", "FaultConfig",
           "DriftConfig", "DeviceFault", "Request", "static_baseline"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine shape/capacity knobs (they pin the two step shapes)."""
    slots: int = 4                # B — decode batch width
    page_size: int = 16           # tokens per KV page
    num_pages: int = 64           # shared pool size (excludes the trash page)
    max_pages_per_slot: int = 0   # per-request page budget; 0 = num_pages
    chunk: int = 32               # C — prefill tokens absorbed per step
    eos_id: Optional[int] = None  # greedy decode stops on this token
    tile_n: int = 256             # analog tile edge for energy accounting
    slot_order: str = "fifo"      # free-slot pick order (determinism test)
    max_steps: int = 100_000      # runaway guard

    @property
    def resolved_max_pages(self) -> int:
        p = self.max_pages_per_slot or self.num_pages
        return min(p, self.num_pages)


@dataclasses.dataclass
class DriftConfig:
    """Online drift detection and recalibration.

    Every ``check_every`` engine steps the engine runs a probe pass
    (``models.model.drift_probe``: the capture of ``model.calibrate``,
    outside the two step programs) on ``probe_batch`` and compares the
    fresh windows and the per-site readout clip rates with the pinned ones.
    Drift is declared when a site clips more than ``clip_threshold`` of its
    |z| elements against its pinned window, or a window moved by more than
    ``window_tol`` in |log ratio|; the fresh windows are then copied into
    the engine's window tensors between steps.  Each probe's largest clip
    rate and |log ratio| go to ``EngineReport.drift_checks``.

    ``observe_every`` > 0 also streams the per-site readout clip rates
    into the engine's ``MetricsSink`` as ``clip_rate.<site>`` series every
    that many steps (the same probe, with no recalibration decision
    attached), so an ``AlertRule`` on one site's clip rate can fire before
    ``check_every`` comes due; without a sink it does nothing.  (The JAX
    package's detect-only mode and probe cache length are not ported:
    nothing sets them.)"""
    probe_batch: dict
    check_every: int = 16
    clip_threshold: float = 0.01
    window_tol: float = 0.25
    observe_every: int = 0


@dataclasses.dataclass
class FaultConfig:
    """Fault wiring for one ``Engine.run`` / ``resume``.

    ``guard`` polls for preemption (install it for SIGTERM handling;
    injected preemptions use the run's own guard); ``snapshot_dir`` makes a
    preemption exit through ``checkpoint.save_engine_snapshot``.
    ``retries``/``backoff_s``/``backoff_cap_s``/``jitter`` parameterize
    ``fault.retry_step`` around both steps.  ``injector`` is a
    ``faultinject.FaultInjector`` schedule; ``drift`` a ``DriftConfig``."""
    guard: Optional[fault.PreemptionGuard] = None
    snapshot_dir: Optional[str] = None
    snapshot_keep: int = 3
    retries: int = 2
    backoff_s: float = 0.01
    backoff_cap_s: float = 1.0
    jitter: float = 0.1
    heartbeat: Optional[fault.Heartbeat] = None
    monitor: Optional[fault.StragglerMonitor] = None
    injector: Optional[Any] = None
    drift: Optional[DriftConfig] = None


class DeviceFault(Exception):
    """A fault no retry mends: a kernel that will not launch, or a CUDA
    error that leaves the context unusable (an illegal address, a
    device-side assert).  Not a RuntimeError, so neither ``retry_step`` nor
    the failed-request path swallows it: the run ends."""


def _device_fault(e: RuntimeError) -> bool:
    # a launch that failed fails again at the same shapes; a poisoned
    # context fails every later call
    return isinstance(e, _build.LaunchError) or _build.poisons_context(e)


@dataclasses.dataclass
class EngineReport:
    """Aggregate run stats + per-request records (rid order)."""
    requests: list[dict]
    steps: int
    prefill_steps: int
    decode_steps: int
    idle_steps: int
    wall_s: float
    prompt_tokens: int
    generated_tokens: int
    utilization: float
    evictions: int
    nan_logit_steps: int
    page_high_water: int
    page_bytes: int
    kv_high_water_bytes: int
    analog_ops: float
    analog_energy_j: float
    fj_per_op: float
    tokens_per_joule: float
    step_shapes: int              # distinct step input shapes (the rule: 2)
    tokens_priced: int = 0        # exact token count behind the energy totals
    site_attribution: Optional[dict] = None   # energy.site_attribution table
    # --- fault tolerance and drift ----------------------------------------
    preempted: bool = False
    snapshot_path: Optional[str] = None
    failed: int = 0
    step_retries: int = 0
    stragglers: int = 0
    straggler_ewma_s: float = 0.0
    heartbeats: int = 0
    recalibrations: int = 0
    drift_events: list = dataclasses.field(default_factory=list)
    drift_checks: list = dataclasses.field(default_factory=list)
    # --- SLA, telemetry and tracing ---------------------------------------
    rejected: int = 0
    over_budget: int = 0
    deadline_hits: int = 0
    deadline_misses: int = 0
    alerts: int = 0
    telemetry: Optional[dict] = None          # MetricsSink.summary()
    trace_summary: Optional[dict] = None      # Tracer.summary()
    # --- mesh-sharded serving ---------------------------------------------
    devices: int = 1              # mesh size (1 = meshless engine)
    total_slots: int = 0          # dp_size * ecfg.slots aggregate decode width
    autotune: Optional[dict] = None           # kernels.tdvmm autotune report

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class RunState:
    """Everything one serving run mutates — the snapshot/restore unit."""
    requests: list[Request]
    records: dict[int, RequestRecord]
    sched: SlotScheduler
    pool: PagePool
    caches: Any
    steps: int = 0
    prefill_steps: int = 0
    decode_steps: int = 0
    idle_steps: int = 0
    prompt_tokens: int = 0
    generated_tokens: int = 0
    evictions: int = 0
    nan_steps: int = 0
    failed: int = 0
    rejected: int = 0
    over_budget: int = 0
    analog_ops: float = 0.0       # running totals, in _account's order (the
    analog_energy_j: float = 0.0  # fj_per_op series)
    tokens_priced: int = 0
    step_retries: int = 0
    recalibrations: int = 0
    last_drift_check: int = 0
    last_clip_obs: int = 0
    wall_s: float = 0.0
    util_samples: list = dataclasses.field(default_factory=list)
    drift_events: list = dataclasses.field(default_factory=list)
    drift_checks: list = dataclasses.field(default_factory=list)
    preempted: bool = False
    snapshot_path: Optional[str] = None


class Engine:
    """Continuous-batching serving engine over ONE model + calibration, on
    the card unless ``device`` says otherwise (raises with no card); with
    ``mesh=`` one rank of a mesh-sharded engine (module docstring).

    ``calib`` pins every enabled digital-boundary site's readout window
    (or the plan sets ``output_calibration=False``/``out_scale``).  The
    engine keeps its own window tensors; ``set_calibration`` and
    ``restore`` update them in place.  ``sla``, ``sink`` and ``tracer``
    are the SLA policy, the metrics sink and the tracer (module
    docstring)."""

    def __init__(self, cfg: ModelConfig, params,
                 engine_cfg: EngineConfig = EngineConfig(),
                 calib: Optional[CalibrationState] = None,
                 sla: Optional[sla_policy.SlaConfig] = None,
                 sink: Optional[Any] = None,
                 tracer: Optional[Any] = None, device=None,
                 mesh: Optional[Any] = None):
        if cfg.family not in ("dense", "moe", "vlm", "audio"):
            raise NotImplementedError(
                f"engine serves attention families, not {cfg.family!r} "
                "(use launch.serve --static for SSM and hybrid models)")
        if cfg.input_mode != "tokens":
            raise NotImplementedError("engine serves token-input models")
        if cfg.swa_window is not None:
            raise NotImplementedError(
                "engine + sliding-window attention not supported yet")
        self.device = model.check_device(params, device)
        self.cfg = cfg
        self.ecfg = engine_cfg
        self.sla = sla
        self.sink = sink
        self.tracer = tracer
        # --- mesh: TP splits each step's math, DP multiplies the slot pool
        self.mesh = mesh
        if mesh is not None:
            from repro_torch.launch.mesh import axis_info
            self._dp_axes = axis_info(mesh)["dp_axes"]
            self.dp = meshctx.axis_size(self._dp_axes, mesh)
            self.devices = mesh.size()
            params = shardlib.shard_tree(params, shardlib.param_specs(
                params, cfg, mesh, dp_axes=(), ep_axes=self._dp_axes), mesh)
        else:
            self._dp_axes, self.dp, self.devices = (), 1, 1
        self.total_slots = self.dp * engine_cfg.slots
        self.params = params
        self.cfg_serving = apply_calibration(cfg, calib)
        self._check_pinned_windows()
        self.energy = energy_model.serving_energy_model(
            self.cfg_serving, engine_cfg.tile_n, n_devices=self.devices)
        self._windows = {site: t.clone() for site, t in
                         calib.as_arrays(self.device).items()} \
            if calib is not None else {}
        # Per-page bytes across all layers (for the high-water stat), from
        # the whole pools' own tensors, made on the meta device (no storage).
        pools = model.init_paged_caches(cfg, engine_cfg.num_pages,
                                        engine_cfg.page_size,
                                        torch.device("meta"), ranks=self.dp)
        total = sum(t.nbytes for pool in pools.values() for t in pool
                    if t is not None)
        self.page_bytes = total // (self.dp * (engine_cfg.num_pages + 1))
        # the pools' placements, from their whole shapes
        self._pool_specs = (shardlib.paged_specs(pools, cfg, mesh)
                            if mesh is not None else None)
        self._st: Optional[RunState] = None
        self._shapes: set = set()
        self._fault: Optional[FaultConfig] = None
        self._guard: Optional[fault.PreemptionGuard] = None

    def _check_pinned_windows(self):
        for site, sc in self.cfg_serving.resolved_tdvmm_plan.sites:
            if (sc.enabled and sc.io_quantize and sc.output_calibration
                    and sc.out_scale is None):
                raise ValueError(
                    f"engine requires a pinned readout window on enabled "
                    f"site {site!r}: per-call data calibration is a max over "
                    f"the whole batch and couples requests together.  Run "
                    f"models.model.calibrate(...) and pass calib=, or set "
                    f"out_scale/output_calibration=False in the plan.")

    # ------------------------------------------------------------------
    # Calibration swap
    # ------------------------------------------------------------------
    def set_calibration(self, calib: CalibrationState) -> None:
        """Swap the pinned windows between steps: the new values are copied
        into the window tensors both steps read, so their storage (and the
        step programs) stay the same.  Sites and shapes must match."""
        new = calib.as_arrays(self.device)
        if set(new) != set(self._windows):
            raise ValueError(
                f"calibration swap covers sites {sorted(new)} but the engine "
                f"serves {sorted(self._windows)} — the site structure is "
                "fixed; build a new engine for a different plan")
        for site, t in new.items():
            if t.shape != self._windows[site].shape:
                raise ValueError(
                    f"calibration swap window for site {site!r} has shape "
                    f"{tuple(t.shape)}, pinned is "
                    f"{tuple(self._windows[site].shape)}")
        for site, t in new.items():
            self._windows[site].copy_(t)

    def pinned_calibration(self) -> CalibrationState:
        """A CPU copy of the currently pinned windows."""
        return CalibrationState(windows={
            site: t.detach().to("cpu", copy=True)
            for site, t in self._windows.items()})

    # ------------------------------------------------------------------
    # Preemption
    # ------------------------------------------------------------------
    def request_preemption(self) -> None:
        """Flag the active run for snapshot-and-exit before its next step
        (what a SIGTERM handler, or an injected preemption, calls)."""
        if self._guard is None:
            self._guard = fault.PreemptionGuard()
        self._guard.requested = True

    # ------------------------------------------------------------------
    # Run lifecycle
    # ------------------------------------------------------------------
    def _make_sched(self) -> SlotScheduler:
        ecfg = self.ecfg
        if self.sla is not None:
            return sla_policy.SlaScheduler(self.total_slots, ecfg.slot_order,
                                           self.sla)
        return SlotScheduler(self.total_slots, ecfg.slot_order)

    def _mesh(self):
        """The engine's mesh installed for model code (a no-op without)."""
        return meshctx.use_mesh_of(self.mesh)

    def _new_pools(self, device):
        with self._mesh():
            return model.init_paged_caches(self.cfg, self.ecfg.num_pages,
                                           self.ecfg.page_size, device,
                                           ranks=self.dp)

    def start(self, requests: list[Request]) -> None:
        """Initialize a fresh run over a trace (allocates the page pools)."""
        rids = [r.rid for r in requests]
        if len(set(rids)) != len(rids):
            raise ValueError("duplicate request ids in trace")
        ecfg = self.ecfg
        sched = self._make_sched()
        sched.add(requests)
        if self.tracer is not None:
            self.tracer.attach(requests)
        self._st = RunState(
            requests=list(requests),
            records={r.rid: RequestRecord(r) for r in requests},
            sched=sched,
            pool=PagePool(ecfg.num_pages, ecfg.page_size, ranks=self.dp),
            caches=self._new_pools(self.device),
        )

    def run(self, requests: list[Request],
            fault_cfg: Optional[FaultConfig] = None) -> EngineReport:
        """Serve a trace to completion (or preemption); returns the report
        (token streams, finish reasons, energy, utilization, memory
        high-water, fault and drift accounting)."""
        self.start(requests)
        return self._drive(fault_cfg)

    def resume(self,
               fault_cfg: Optional[FaultConfig] = None) -> EngineReport:
        """Continue a run restored by ``restore`` (or one that exited
        preempted in this process) to completion."""
        if self._st is None:
            raise RuntimeError("no run state: call run() or restore() first")
        self._st.preempted = False
        self._st.snapshot_path = None
        return self._drive(fault_cfg)

    @torch.no_grad()
    def _drive(self, fault_cfg: Optional[FaultConfig]) -> EngineReport:
        st = self._st
        fc = self._fault = fault_cfg
        guard = (fc.guard if fc is not None else None) \
            or fault.PreemptionGuard()
        self._guard = guard
        t0 = time.perf_counter()
        try:
            while True:
                if fc is not None and fc.injector is not None:
                    fc.injector.on_tick(self, st.steps)
                if guard.requested:
                    raise fault.Preempted(f"preempted at step {st.steps}")
                t1 = time.perf_counter()
                alive = self.tick()
                dt = time.perf_counter() - t1
                if self.tracer is not None:
                    self.tracer.tick_done(st.steps, dt, {
                        "queue_depth": len(st.sched.pending),
                        "active_slots": len(st.sched.occupied()),
                        "pages_in_use": st.pool.in_use,
                        "fj_per_op": (st.analog_energy_j / st.analog_ops
                                      * 1e15) if st.analog_ops else 0.0,
                    })
                if self.sink is not None:
                    self._observe_tick(dt)
                if fc is not None:
                    if fc.monitor is not None:
                        fc.monitor.record(st.steps, dt)
                    if fc.heartbeat is not None:
                        fc.heartbeat.beat(st.steps)
                    if (fc.drift is not None and fc.drift.observe_every
                            and self.sink is not None and st.steps -
                            st.last_clip_obs >= fc.drift.observe_every):
                        st.last_clip_obs = st.steps
                        self._observe_clips(fc.drift)
                    if (fc.drift is not None and st.steps -
                            st.last_drift_check >= fc.drift.check_every):
                        st.last_drift_check = st.steps
                        self._drift_check(fc.drift)
                if not alive:
                    break
        except fault.Preempted:
            st.preempted = True
            st.wall_s += time.perf_counter() - t0
            if self.sink is not None:
                self.sink.flush()        # metrics land before the snapshot
            if fc is not None and fc.snapshot_dir is not None:
                from repro_torch.checkpoint import checkpoint as ckpt
                path = ckpt.save_engine_snapshot(
                    self.snapshot(), fc.snapshot_dir, step=st.steps,
                    keep=fc.snapshot_keep)
                st.snapshot_path = str(path)
            return self.report()
        st.wall_s += time.perf_counter() - t0
        return self.report()

    def _observe_tick(self, dt: float) -> None:
        """Feed the metrics sink after one tick: host integers and floats
        only (no device tensor is read, so no sync is added)."""
        st = self._st
        step = st.steps          # the tick just executed landed us here
        sink = self.sink
        sink.observe("step_latency_s", dt, step)
        sink.observe("queue_depth", len(st.sched.pending), step)
        sink.observe("active_slots", len(st.sched.occupied()), step)
        sink.observe("page_in_use", st.pool.in_use, step)
        sink.observe("page_high_water", st.pool.high_water, step)
        sink.observe("generated_tokens", st.generated_tokens, step)
        sink.observe("step_retries", st.step_retries, step)
        if st.analog_ops > 0.0:
            sink.observe("fj_per_op",
                         st.analog_energy_j / st.analog_ops * 1e15, step)

    # ------------------------------------------------------------------
    # One scheduling tick
    # ------------------------------------------------------------------
    def tick(self) -> bool:
        """One engine iteration: admit, then run one prefill chunk OR one
        batched decode step OR fast-forward to the next arrival.  Returns
        False when the trace is fully served."""
        with span("engine.tick"):
            st = self._st
            if st.steps > self.ecfg.max_steps:
                raise RuntimeError(
                    f"engine exceeded max_steps={self.ecfg.max_steps}")
            if self.tracer is not None:
                # open `queued` spans (idempotent)
                for req in st.sched.pending:
                    if req.arrival_step <= st.steps:
                        self.tracer.note_arrival(req.rid, st.steps)
            self._admit()
            occupied = st.sched.occupied()
            prefilling = [s for s in occupied if s.prefilling]
            decoding = [s for s in occupied if not s.prefilling]
            if prefilling:
                self._prefill_tick(prefilling[0])
                return True
            if decoding:
                self._decode_tick(decoding)
                return True
            if st.sched.has_pending():
                nxt = st.sched.next_arrival()
                if nxt is None or nxt <= st.steps:
                    raise RuntimeError(
                        "scheduler stall: pending request cannot be admitted "
                        "into an empty engine (page budget inconsistency)")
                if self.tracer is not None:
                    self.tracer.mark_idle(st.steps, nxt)
                st.idle_steps += nxt - st.steps
                st.steps = nxt
                return True
            return False

    def _admit(self) -> None:
        """Admission (FIFO, or priority with aging under ``sla=``);
        head-of-line blocks on pool pressure.  SLA infeasibility is checked
        first: a rejected request never occupies a slot, never allocates a
        page and never reaches a step."""
        st = self._st
        ecfg = self.ecfg
        cap_pages = ecfg.resolved_max_pages
        while True:
            req = st.sched.head(st.steps)
            if req is None:
                break
            if self.sla is not None:
                verdict = sla_policy.admission_verdict(
                    req, st.steps, ecfg.chunk, self.energy)
                if verdict is not None:
                    st.sched.pop_head()
                    rec = st.records[req.rid]
                    rec.admitted_step = rec.finished_step = st.steps
                    rec.finish_reason = "rejected"
                    rec.reject_reason = verdict
                    st.rejected += 1
                    if self.tracer is not None:
                        self.tracer.finished(req.rid, st.steps, "rejected")
                    continue
            need = pages_for(len(req.prompt), ecfg.page_size)
            if need > cap_pages:
                # can never fit: reject without occupying a slot
                st.sched.pop_head()
                rec = st.records[req.rid]
                rec.admitted_step = rec.finished_step = st.steps
                rec.finish_reason = "evicted"
                st.evictions += 1
                if self.tracer is not None:
                    self.tracer.finished(req.rid, st.steps, "evicted")
                continue
            sid = st.sched.free_slot_id()
            if sid is None:
                break
            pages = st.pool.alloc(need, rank=sid // ecfg.slots)
            if pages is None:
                break
            st.sched.pop_head()
            rec = st.records[req.rid]
            rec.admitted_step = st.steps
            st.sched.place(sid, rec, pages)
            if self.tracer is not None:
                self.tracer.admitted(req.rid, st.steps, sid, 0, len(pages))

    def _finish(self, slot: Slot, reason: str) -> None:
        st = self._st
        slot.record.finish_reason = reason
        slot.record.finished_step = st.steps
        if self.tracer is not None:
            self.tracer.finished(slot.record.request.rid, st.steps, reason)
        if reason == "evicted":
            st.evictions += 1
        elif reason == "failed":
            st.failed += 1
        elif reason == "over_budget":
            st.over_budget += 1
        st.pool.free(slot.pages)
        st.sched.release(slot)

    def _emit(self, slot: Slot, tok: int) -> None:
        """Stream one generated token; finish on eos/budget.

        Under an SLA policy a request whose accumulated joules crossed its
        ``joule_budget`` is finished ``over_budget``: the token it just
        produced still streams (the work was done and priced), its slot and
        pages recycle, and its neighbours' streams are unchanged (the same
        row-isolation argument as the ``failed`` path)."""
        rec = slot.record
        rec.tokens.append(tok)
        if rec.first_token_step < 0:
            rec.first_token_step = self._st.steps
        if self.ecfg.eos_id is not None and tok == self.ecfg.eos_id:
            self._finish(slot, "eos")
        elif (self.sla is not None and rec.request.joule_budget is not None
                and rec.analog_energy_j > rec.request.joule_budget):
            self._finish(slot, "over_budget")
        elif len(rec.tokens) >= rec.request.max_new_tokens:
            self._finish(slot, "max_tokens")
        else:
            slot.cur_token = tok

    def _account(self, rec: RequestRecord, n: int) -> None:
        st = self._st
        ops, e_j = energy_model.token_cost(self.energy, n)
        rec.analog_ops += ops
        rec.analog_energy_j += e_j
        st.analog_ops += ops
        st.analog_energy_j += e_j
        st.tokens_priced += n         # the exact count behind site_attribution

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def _step(self, kind: str, fn, batch: dict):
        """The retry boundary around one step.  Injected faults raise
        before ``fn`` runs; a real failure inside ``fn`` may have written
        part of the step's page positions, which the retry rewrites with
        the same values (a step writes only the positions it absorbs)."""
        self._shapes.add((kind,) + tuple(
            (k, tuple(v.shape)) for k, v in sorted(batch.items())))
        fc, st = self._fault, self._st

        def call():
            if fc is not None and fc.injector is not None:
                fc.injector.check(kind, st.steps)
            try:
                with self._mesh():
                    return fn(self.params, batch, st.caches, self.cfg,
                              windows=self._windows)
            except RuntimeError as e:
                if _device_fault(e):
                    raise DeviceFault(str(e)) from e
                raise

        if fc is None:
            return call()

        def on_retry(attempt, e):
            st.step_retries += 1

        return fault.retry_step(
            call, retries=fc.retries, backoff_s=fc.backoff_s,
            backoff_cap_s=fc.backoff_cap_s, jitter=fc.jitter,
            on_retry=on_retry, guard=self._guard)

    def _prefill_tick(self, slot: Slot) -> None:
        """One prefill chunk (oldest admission first)."""
        st = self._st
        ecfg = self.ecfg
        prompt = slot.record.request.prompt
        start = slot.prefill_done
        n = min(ecfg.chunk, len(prompt) - start)
        tokens = np.zeros((1, ecfg.chunk), np.int32)
        tokens[0, :n] = prompt[start:start + n]
        row = np.full((ecfg.resolved_max_pages,), st.pool.trash_page,
                      np.int32)
        row[:len(slot.pages)] = slot.pages
        batch = {"inputs": self._tensor(tokens),
                 "block_row": self._tensor(row),
                 "offset": self._tensor(np.asarray(start, np.int32)),
                 "valid": self._tensor(np.asarray(n, np.int32))}
        try:
            logits, st.caches = self._step("prefill", model.prefill_chunk,
                                           batch)
        except RuntimeError:
            # persistent step failure: this slot is the step's work —
            # finish it failed and re-plan next tick
            self._finish(slot, "failed")
            return
        st.prefill_steps += 1
        slot.prefill_done += n
        slot.pos += n
        st.prompt_tokens += n
        self._account(slot.record, n)
        if self.tracer is not None:
            self.tracer.mark_chunk(
                slot.record.request.rid, start // ecfg.chunk, n,
                done=not slot.prefilling, step=st.steps)
        if not slot.prefilling:
            row_logits = logits[0, 0]
            tok = int(torch.argmax(row_logits[:self.cfg.vocab_size]))
            st.nan_steps += int(bool(torch.isnan(row_logits).any()))
            st.generated_tokens += 1
            self._account(slot.record, 1)
            self._emit(slot, tok)
        st.steps += 1

    def _decode_tick(self, decoding: list[Slot]) -> None:
        """One batched decode step over all decoding slots."""
        st = self._st
        ecfg = self.ecfg
        ps, cap_pages = ecfg.page_size, ecfg.resolved_max_pages
        # --- evict-before-poison: secure every slot's write page ----------
        runnable = []
        for slot in decoding:
            if slot.pos >= len(slot.pages) * ps:
                if len(slot.pages) >= cap_pages or \
                        (new := st.pool.alloc(
                            1, rank=slot.sid // ecfg.slots)) is None:
                    self._finish(slot, "evicted")
                    continue
                slot.pages.extend(new)
            runnable.append(slot)
        if not runnable:
            return                # state changed (evictions); re-plan
        b = self.total_slots
        tokens = np.zeros((b, 1), np.int32)
        pos = np.zeros((b,), np.int32)
        tables = np.full((b, cap_pages), st.pool.trash_page, np.int32)
        active = np.zeros((b,), bool)
        for slot in runnable:
            tokens[slot.sid, 0] = slot.cur_token
            pos[slot.sid] = slot.pos
            tables[slot.sid, :len(slot.pages)] = slot.pages
            active[slot.sid] = True
        batch = {"inputs": self._tensor(tokens),
                 "block_tables": self._tensor(tables),
                 "pos": self._tensor(pos),
                 "active": self._tensor(active)}
        if self.mesh is not None:
            # rows ordered (dp_rank, local_slot): this rank runs its own
            specs = shardlib.slot_specs(self.mesh, "decode")
            batch = {k: shardlib.shard(v, specs[k], self.mesh)
                     for k, v in batch.items()}
        try:
            logits, st.caches = self._step("decode", model.decode_slots,
                                           batch)
        except RuntimeError as e:
            # persistent step failure: blame the attributed request (or the
            # oldest runnable slot), finish it failed, re-plan next tick;
            # decode rows are independent, so the others' streams hold
            rid = getattr(e, "rid", None)
            culprit = next(
                (s for s in runnable if s.record.request.rid == rid), None)
            if culprit is None:
                culprit = min(runnable, key=lambda s: s.seq)
            self._finish(culprit, "failed")
            return
        st.decode_steps += 1
        if self.tracer is not None:
            self.tracer.mark_decode(
                [s.record.request.rid for s in runnable], st.steps)
        st.util_samples.append(len(runnable) / b)
        row_logits = logits[:, 0]
        toks = torch.argmax(row_logits[:, :self.cfg.vocab_size], dim=-1)
        nans = torch.isnan(row_logits).any(dim=-1)
        if self.dp > 1:
            # every rank's scheduler needs every rank's samples
            with self._mesh():
                both = meshctx.all_gather(
                    torch.stack([toks, nans.to(toks.dtype)]),
                    meshctx.dp_group(), 1)
            toks, nans = both[0], both[1].bool()
        toks, nans = toks.cpu(), nans.cpu()
        for slot in runnable:              # admission order
            st.nan_steps += int(nans[slot.sid])
            slot.pos += 1
            st.generated_tokens += 1
            self._account(slot.record, 1)
            self._emit(slot, int(toks[slot.sid]))
        st.steps += 1

    # ------------------------------------------------------------------
    # Drift detection and online recalibration
    # ------------------------------------------------------------------
    def _observe_clips(self, dc: DriftConfig) -> None:
        """Stream the per-site readout clip rates into the sink as
        ``clip_rate.<site>`` series (``DriftConfig.observe_every``): one
        ``drift_probe``, outside the two step programs, its tallies read
        once, with no recalibration decision attached."""
        with self._mesh():
            _, clips = model.drift_probe(
                self.params, dc.probe_batch, self.cfg,
                self.pinned_calibration(), device=self.device)
        for name, v in clip_rate_metrics(clips).items():
            self.sink.observe(name, v, self._st.steps)

    def _drift_check(self, dc: DriftConfig) -> None:
        st = self._st
        pinned = self.pinned_calibration()
        t0 = time.perf_counter()
        with self._mesh():
            fresh, clips = model.drift_probe(
                self.params, dc.probe_batch, self.cfg, pinned,
                device=self.device)
        ratios = pinned.drift_ratios(fresh)
        max_clip = max(clips.values(), default=0.0)
        max_dev = max((abs(math.log(max(r, 1e-12)))
                       for r in ratios.values()), default=0.0)
        st.drift_checks.append({
            "step": st.steps, "max_clip_rate": float(max_clip),
            "max_log_ratio": float(max_dev),
            "seconds": time.perf_counter() - t0})
        if self.sink is not None:
            self.sink.observe("drift_max_clip_rate", float(max_clip),
                              st.steps)
            self.sink.observe("drift_max_log_ratio", float(max_dev),
                              st.steps)
            for name, v in clip_rate_metrics(clips).items():
                self.sink.observe(name, v, st.steps)
        if not (max_clip > dc.clip_threshold or max_dev > dc.window_tol):
            return
        st.drift_events.append({
            "step": st.steps, "max_clip_rate": float(max_clip),
            "max_log_ratio": float(max_dev),
            "clip_rates": {k: float(v) for k, v in clips.items()},
            "ratios": {k: float(v) for k, v in ratios.items()}})
        self.set_calibration(fresh)
        st.recalibrations += 1

    # ------------------------------------------------------------------
    # Snapshot / restore
    # ------------------------------------------------------------------
    def _model_id(self) -> dict:
        return {"vocab_size": self.cfg.vocab_size,
                "n_layers": self.cfg.n_layers, "d_model": self.cfg.d_model,
                "family": self.cfg.family}

    def snapshot(self) -> dict:
        """The whole in-flight state as one checkpointable tree:
        ``caches`` (CPU copies of the page pools), ``windows`` (the pinned,
        possibly recalibrated, windows) and ``meta`` (a uint8 tensor of the
        JSON of every host-side structure: requests, records, scheduler
        queue, slots and block tables, the page pool's free list,
        counters, the SLA policy, the metrics sink's and the tracer's
        state; the JAX package's meta version 4).  The weights are not
        included: the restoring process builds its Engine with the same
        params.  Valid between ticks, where a preemption leaves the
        engine."""
        st = self._st
        if st is None:
            raise RuntimeError("no run state to snapshot")
        meta = {
            "version": 4,
            "dp": self.dp,
            "ecfg": dataclasses.asdict(self.ecfg),
            "model": self._model_id(),
            "sla": (dataclasses.asdict(self.sla)
                    if self.sla is not None else None),
            "telemetry": (self.sink.snapshot()
                          if self.sink is not None else None),
            "trace": (self.tracer.snapshot()
                      if self.tracer is not None else None),
            "requests": [
                {"rid": r.rid, "prompt": list(r.prompt),
                 "max_new_tokens": r.max_new_tokens,
                 "arrival_step": r.arrival_step, "priority": r.priority,
                 "deadline_steps": r.deadline_steps,
                 "joule_budget": r.joule_budget} for r in st.requests],
            "records": {
                str(rid): {
                    "tokens": list(rec.tokens),
                    "finish_reason": rec.finish_reason,
                    "admitted_step": rec.admitted_step,
                    "first_token_step": rec.first_token_step,
                    "finished_step": rec.finished_step,
                    "analog_ops": rec.analog_ops,
                    "analog_energy_j": rec.analog_energy_j,
                    "reject_reason": rec.reject_reason,
                } for rid, rec in st.records.items()},
            "sched": {
                "pending": [r.rid for r in st.sched.pending],
                "seq": st.sched._seq,
                "slots": [
                    None if s is None else {
                        "sid": s.sid, "seq": s.seq,
                        "rid": s.record.request.rid,
                        "pages": list(s.pages), "pos": s.pos,
                        "prefill_done": s.prefill_done,
                        "cur_token": s.cur_token,
                    } for s in st.sched.slots]},
            "pool": {"free": st.pool.free_lists(),
                     "high_water": st.pool.high_water},
            "counters": {
                "steps": st.steps, "prefill_steps": st.prefill_steps,
                "decode_steps": st.decode_steps,
                "idle_steps": st.idle_steps,
                "prompt_tokens": st.prompt_tokens,
                "generated_tokens": st.generated_tokens,
                "evictions": st.evictions, "nan_steps": st.nan_steps,
                "failed": st.failed, "rejected": st.rejected,
                "over_budget": st.over_budget,
                "analog_ops": st.analog_ops,
                "analog_energy_j": st.analog_energy_j,
                "tokens_priced": st.tokens_priced,
                "step_retries": st.step_retries,
                "recalibrations": st.recalibrations,
                "last_drift_check": st.last_drift_check,
                "last_clip_obs": st.last_clip_obs,
                "wall_s": st.wall_s,
                "util_samples": [float(u) for u in st.util_samples],
                "drift_events": st.drift_events,
                "drift_checks": st.drift_checks,
            },
        }
        blob = torch.frombuffer(bytearray(json.dumps(meta).encode("utf-8")),
                                dtype=torch.uint8)
        return {
            "caches": tree_map(lambda t: t.detach().to("cpu", copy=True),
                               self._full_pools(st.caches)),
            "windows": {site: t.detach().to("cpu", copy=True)
                        for site, t in self._windows.items()},
            "meta": blob,
        }

    def _full_pools(self, caches):
        """The whole page pools from this rank's: each page region from the
        rank that owns it (a region's decode writes land on its owner
        only), the KV heads gathered over ``model``.  Collective."""
        if self.mesh is None:
            return caches
        with self._mesh():
            specs = self._pool_specs
            stride = self.ecfg.num_pages + 1

            def full(t, spec):
                if self.dp > 1:
                    every = meshctx.all_gather(t[None], meshctx.dp_group(), 0)
                    t = torch.cat([every[r, :, r * stride:(r + 1) * stride]
                                   for r in range(self.dp)], dim=1)
                return shardlib.gather(t, spec, self.mesh)
            return tree_map(full, caches, specs)

    def restore(self, snap) -> None:
        """Rebuild the in-flight state from ``snapshot()`` output — the
        nested tree or the flat name -> tensor dict that
        ``checkpoint.load_engine_snapshot`` returns.  Checks the engine
        config, the model, the SLA policy (it must equal this engine's: it
        decides the admission order), that a snapshot carrying telemetry or
        trace state meets a sink or a tracer to take it, the window
        structure and every page pool's shape and dtype before it changes
        anything; then the sink and the tracer continue the snapshot's
        series and spans, the windows are copied into the engine's window
        tensors and the pools into pools made by ``model.init_paged_caches``
        on the engine's device.  ``resume`` then continues the trace."""
        flat = dict(leaves_with_paths(snap))
        if "meta" not in flat:
            raise ValueError("engine snapshot missing 'meta' leaf")
        meta = json.loads(flat["meta"].detach().cpu().numpy().tobytes()
                          .decode("utf-8"))
        mine = dataclasses.asdict(self.ecfg)
        if meta["ecfg"] != mine:
            raise ValueError(
                f"engine snapshot was taken with EngineConfig "
                f"{meta['ecfg']}, this engine has {mine} — the config pins "
                "the step shapes and cannot change across resume")
        snap_dp = meta.get("dp", 1)
        if snap_dp != self.dp:
            raise ValueError(
                f"engine snapshot was taken over {snap_dp} data-parallel "
                f"ranks, this engine has {self.dp} — the DP slot-pool "
                "layout (slot ids, page regions) cannot change across "
                "resume")
        if meta["model"] != self._model_id():
            raise ValueError(f"engine snapshot model {meta['model']} != "
                             f"{self._model_id()}")
        snap_sla = meta.get("sla")
        mine_sla = (dataclasses.asdict(self.sla)
                    if self.sla is not None else None)
        if snap_sla != mine_sla:
            raise ValueError(
                f"engine snapshot was taken under SLA policy {snap_sla}, "
                f"this engine has {mine_sla} — the policy drives admission "
                "order and must match for the same streams on resume")
        snap_telemetry = meta.get("telemetry")
        if snap_telemetry is not None and self.sink is None:
            raise ValueError(
                "engine snapshot carries telemetry state but this engine has "
                "no sink — construct it with sink= to resume the metric "
                "series and alert history")
        snap_trace = meta.get("trace")
        if snap_trace is not None and self.tracer is None:
            raise ValueError(
                "engine snapshot carries trace state but this engine has no "
                "tracer — construct it with tracer= to resume the span "
                "stream as one continuous trace")
        # --- windows and page pools: check all, then copy in place --------
        win = {k[len("windows/"):]: v for k, v in flat.items()
               if k.startswith("windows/")}
        if set(win) != set(self._windows):
            raise ValueError(f"snapshot windows {sorted(win)} != engine "
                             f"sites {sorted(self._windows)}")
        for site, t in win.items():
            if tuple(t.shape) != tuple(self._windows[site].shape):
                raise ValueError(
                    f"snapshot window {site!r} shape {tuple(t.shape)} != "
                    f"{tuple(self._windows[site].shape)}")
        ecfg = self.ecfg
        like = leaves_with_paths(model.init_paged_caches(
            self.cfg, ecfg.num_pages, ecfg.page_size, torch.device("meta"),
            ranks=self.dp))
        have = {k[len("caches/"):] for k in flat if k.startswith("caches/")}
        if have != {name for name, _ in like}:
            raise ValueError(
                f"snapshot page pools {sorted(have)} != this engine's "
                f"{sorted(name for name, _ in like)}")
        for name, sh in like:
            t = flat[f"caches/{name}"]
            if tuple(t.shape) != tuple(sh.shape) or t.dtype != sh.dtype:
                raise ValueError(
                    f"cache leaf {name}: snapshot {tuple(t.shape)}/{t.dtype}"
                    f" != expected {tuple(sh.shape)}/{sh.dtype}")
        if snap_telemetry is not None:
            self.sink.restore(snap_telemetry)
        if snap_trace is not None:
            self.tracer.restore(snap_trace)
        for site, t in win.items():
            self._windows[site].copy_(t)
        caches = self._new_pools(self.device)
        specs = (dict(leaves_with_paths(self._pool_specs))
                 if self.mesh is not None else {})
        for name, t in leaves_with_paths(caches):
            src = flat[f"caches/{name}"]
            if name in specs:
                with self._mesh():
                    src = shardlib.shard(src, specs[name], self.mesh)
            t.copy_(src)

        # --- host bookkeeping ---------------------------------------------
        requests = [Request(rid=r["rid"], prompt=tuple(r["prompt"]),
                            max_new_tokens=r["max_new_tokens"],
                            arrival_step=r["arrival_step"],
                            priority=r.get("priority", 0),
                            deadline_steps=r.get("deadline_steps"),
                            joule_budget=r.get("joule_budget"))
                    for r in meta["requests"]]
        by_rid = {r.rid: r for r in requests}
        records = {}
        for rid_s, rd in meta["records"].items():
            rec = RequestRecord(by_rid[int(rid_s)])
            rec.tokens = list(rd["tokens"])
            rec.finish_reason = rd["finish_reason"]
            rec.admitted_step = rd["admitted_step"]
            rec.first_token_step = rd["first_token_step"]
            rec.finished_step = rd["finished_step"]
            rec.analog_ops = rd["analog_ops"]
            rec.analog_energy_j = rd["analog_energy_j"]
            rec.reject_reason = rd.get("reject_reason")
            records[int(rid_s)] = rec
        sched = self._make_sched()
        sched.pending = [by_rid[rid] for rid in meta["sched"]["pending"]]
        sched._seq = meta["sched"]["seq"]
        for sd in meta["sched"]["slots"]:
            if sd is not None:
                sched.slots[sd["sid"]] = Slot(
                    sid=sd["sid"], seq=sd["seq"], record=records[sd["rid"]],
                    pages=list(sd["pages"]), pos=sd["pos"],
                    prefill_done=sd["prefill_done"],
                    cur_token=sd["cur_token"])
        pool = PagePool(ecfg.num_pages, ecfg.page_size, ranks=self.dp)
        pool.restore_free(meta["pool"]["free"])
        pool.high_water = meta["pool"]["high_water"]
        c = meta["counters"]
        self._st = RunState(
            requests=requests, records=records, sched=sched, pool=pool,
            caches=caches, steps=c["steps"],
            prefill_steps=c["prefill_steps"],
            decode_steps=c["decode_steps"], idle_steps=c["idle_steps"],
            prompt_tokens=c["prompt_tokens"],
            generated_tokens=c["generated_tokens"],
            evictions=c["evictions"], nan_steps=c["nan_steps"],
            failed=c["failed"], rejected=c.get("rejected", 0),
            over_budget=c.get("over_budget", 0),
            # snapshots written before the running totals: the records' sums
            analog_ops=c.get("analog_ops", sum(
                r.analog_ops for r in records.values())),
            analog_energy_j=c.get("analog_energy_j", sum(
                r.analog_energy_j for r in records.values())),
            tokens_priced=c["tokens_priced"],
            step_retries=c["step_retries"],
            recalibrations=c["recalibrations"],
            last_drift_check=c["last_drift_check"],
            last_clip_obs=c.get("last_clip_obs", 0), wall_s=c["wall_s"],
            util_samples=list(c["util_samples"]),
            drift_events=list(c["drift_events"]),
            drift_checks=list(c["drift_checks"]))

    # ------------------------------------------------------------------
    def report(self) -> EngineReport:
        """The report for the current (finished, preempted or in-flight)
        run state."""
        st = self._st
        if st is None:
            raise RuntimeError("no run state to report")
        fc = self._fault
        mon = fc.monitor if fc is not None else None
        hb = fc.heartbeat if fc is not None else None
        if self.sink is not None:
            self.sink.flush()     # buffered emitters reach disk with report
        # Aggregates are derived from the per-site attribution table, so the
        # site table sums bit-exactly to analog_ops/analog_energy_j/fj_per_op.
        attr = energy_model.site_attribution(self.energy, st.tokens_priced)
        tot_ops, tot_e = attr["ops"], attr["energy_j"]
        # deadline outcomes over admitted finished requests: a rejection is
        # admission control working (counted in `rejected`), not a miss
        hits = [r.deadline_hit for r in st.records.values()
                if r.done and r.finish_reason != "rejected"
                and r.deadline_hit is not None]
        return EngineReport(
            requests=[st.records[r.rid].summary() for r in st.requests],
            steps=st.steps,
            prefill_steps=st.prefill_steps,
            decode_steps=st.decode_steps,
            idle_steps=st.idle_steps,
            wall_s=st.wall_s,
            prompt_tokens=st.prompt_tokens,
            generated_tokens=st.generated_tokens,
            utilization=(float(np.mean(st.util_samples))
                         if st.util_samples else 0.0),
            evictions=st.evictions,
            nan_logit_steps=st.nan_steps,
            page_high_water=st.pool.high_water,
            page_bytes=self.page_bytes,
            kv_high_water_bytes=(st.pool.high_water + 1) * self.page_bytes,
            analog_ops=tot_ops,
            analog_energy_j=tot_e,
            fj_per_op=(tot_e / tot_ops * 1e15) if tot_ops else 0.0,
            tokens_per_joule=(st.generated_tokens / tot_e) if tot_e else 0.0,
            step_shapes=len(self._shapes),
            tokens_priced=st.tokens_priced,
            site_attribution=attr,
            preempted=st.preempted,
            snapshot_path=st.snapshot_path,
            failed=st.failed,
            step_retries=st.step_retries,
            stragglers=mon.stragglers if mon is not None else 0,
            straggler_ewma_s=mon.ewma if mon is not None else 0.0,
            heartbeats=hb.beats if hb is not None else 0,
            recalibrations=st.recalibrations,
            drift_events=list(st.drift_events),
            drift_checks=list(st.drift_checks),
            rejected=st.rejected,
            over_budget=st.over_budget,
            deadline_hits=sum(1 for h in hits if h),
            deadline_misses=sum(1 for h in hits if not h),
            alerts=len(self.sink.alerts) if self.sink is not None else 0,
            telemetry=(self.sink.summary()
                       if self.sink is not None else None),
            trace_summary=(self.tracer.summary()
                           if self.tracer is not None else None),
            devices=self.devices,
            total_slots=self.total_slots,
            autotune=tdvmm_ops.autotune_report(
                tdvmm.autotune_platform(self.device)),
        )
