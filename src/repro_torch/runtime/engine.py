"""Continuous-batching TD-VMM serving engine — torch port of
``repro.runtime.engine`` (single device; no fault tolerance, drift, SLA,
telemetry or tracing yet).

The paper's system discipline — fixed conversion circuitry, time-multiplexed
inputs — maps onto serving as two fixed-shape step functions (a chunked
prefill step of shape (1, C) and a batched decode step of shape (B, 1)) that
a ragged request stream is multiplexed through:

  * a fixed pool of B decode **slots**, admitted FIFO by arrival
    (``runtime/scheduler.py``);
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

Request lifecycle::

    pending --admit(slot+pages)--> prefilling --last chunk--> decoding
       |                                                         |
       +--> evicted (prompt exceeds page budget)                 +--> eos
                                                                 +--> max_tokens
                                                                 +--> evicted
                                                   (evicted: page budget
                                                    exhausted — finished
                                                    BEFORE the overflowing
                                                    write)

Energy: every processed token is priced by the resolved plan's analog-tile
geometry (``core.energy.serving_energy_model``) into per-request Op counts
and joules — the paper's fJ/Op, measured at request level.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import energy as energy_model
from repro_torch.core.calibration import CalibrationState, apply_calibration
from repro_torch.models import model
from repro_torch.runtime.paged_cache import PagePool, pages_for
from repro_torch.runtime.scheduler import (Request, RequestRecord, Slot,
                                           SlotScheduler, static_baseline)

__all__ = ["Engine", "EngineConfig", "EngineReport", "Request",
           "static_baseline"]


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

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class RunState:
    """Everything one serving run mutates."""
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
    tokens_priced: int = 0
    wall_s: float = 0.0
    util_samples: list = dataclasses.field(default_factory=list)


class Engine:
    """Continuous-batching serving engine over ONE model + calibration, on
    the card unless ``device`` says otherwise (raises with no card).

    ``calib`` pins every enabled digital-boundary site's readout window
    (or the plan sets ``output_calibration=False``/``out_scale``)."""

    def __init__(self, cfg: ModelConfig, params,
                 engine_cfg: EngineConfig = EngineConfig(),
                 calib: Optional[CalibrationState] = None, device=None):
        if cfg.family not in ("dense", "vlm", "audio"):
            raise NotImplementedError(
                f"engine serves dense attention models, not {cfg.family!r} "
                "(use launch.serve --static for SSM and hybrid models)")
        if cfg.input_mode != "tokens":
            raise NotImplementedError("engine serves token-input models")
        if cfg.swa_window is not None:
            raise NotImplementedError(
                "engine + sliding-window attention not supported yet")
        self.device = model.check_device(params, device)
        self.cfg = cfg
        self.ecfg = engine_cfg
        self.params = params
        self.cfg_serving = apply_calibration(cfg, calib)
        self._check_pinned_windows()
        self.energy = energy_model.serving_energy_model(
            self.cfg_serving, engine_cfg.tile_n)
        self._windows = calib.as_arrays(self.device) if calib is not None \
            else {}
        # Per-page bytes across all layers (for the high-water stat), from
        # the pools' own tensors, made on the meta device (no storage).
        pools = model.init_paged_caches(cfg, engine_cfg.num_pages,
                                        engine_cfg.page_size,
                                        torch.device("meta"))
        total = sum(t.nbytes for pool in pools.values() for t in pool
                    if t is not None)
        self.page_bytes = total // (engine_cfg.num_pages + 1)
        self._st: Optional[RunState] = None
        self._shapes: set = set()

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
    # Run lifecycle
    # ------------------------------------------------------------------
    def start(self, requests: list[Request]) -> None:
        """Initialize a fresh run over a trace (allocates the page pools)."""
        rids = [r.rid for r in requests]
        if len(set(rids)) != len(rids):
            raise ValueError("duplicate request ids in trace")
        ecfg = self.ecfg
        sched = SlotScheduler(ecfg.slots, ecfg.slot_order)
        sched.add(requests)
        self._st = RunState(
            requests=list(requests),
            records={r.rid: RequestRecord(r) for r in requests},
            sched=sched,
            pool=PagePool(ecfg.num_pages, ecfg.page_size),
            caches=model.init_paged_caches(self.cfg, ecfg.num_pages,
                                           ecfg.page_size, self.device),
        )

    @torch.no_grad()
    def run(self, requests: list[Request]) -> EngineReport:
        """Serve a trace to completion; returns the report (token streams,
        finish reasons, energy, utilization, memory high-water)."""
        self.start(requests)
        st = self._st
        t0 = time.perf_counter()
        while self.tick():
            pass
        st.wall_s += time.perf_counter() - t0
        return self.report()

    # ------------------------------------------------------------------
    # One scheduling tick
    # ------------------------------------------------------------------
    def tick(self) -> bool:
        """One engine iteration: admit, then run one prefill chunk OR one
        batched decode step OR fast-forward to the next arrival.  Returns
        False when the trace is fully served."""
        st = self._st
        if st.steps > self.ecfg.max_steps:
            raise RuntimeError(f"engine exceeded max_steps={self.ecfg.max_steps}")
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
            st.idle_steps += nxt - st.steps
            st.steps = nxt
            return True
        return False

    def _admit(self) -> None:
        """FIFO admission; head-of-line blocks on pool pressure."""
        st = self._st
        ecfg = self.ecfg
        cap_pages = ecfg.resolved_max_pages
        while True:
            req = st.sched.head(st.steps)
            if req is None:
                break
            need = pages_for(len(req.prompt), ecfg.page_size)
            if need > cap_pages:
                # can never fit: reject without occupying a slot
                st.sched.pop_head()
                rec = st.records[req.rid]
                rec.admitted_step = rec.finished_step = st.steps
                rec.finish_reason = "evicted"
                st.evictions += 1
                continue
            sid = st.sched.free_slot_id()
            if sid is None:
                break
            pages = st.pool.alloc(need)
            if pages is None:
                break
            st.sched.pop_head()
            rec = st.records[req.rid]
            rec.admitted_step = st.steps
            st.sched.place(sid, rec, pages)

    def _finish(self, slot: Slot, reason: str) -> None:
        st = self._st
        slot.record.finish_reason = reason
        slot.record.finished_step = st.steps
        if reason == "evicted":
            st.evictions += 1
        st.pool.free(slot.pages)
        st.sched.release(slot)

    def _emit(self, slot: Slot, tok: int) -> None:
        """Stream one generated token; finish on eos/budget."""
        rec = slot.record
        rec.tokens.append(tok)
        if rec.first_token_step < 0:
            rec.first_token_step = self._st.steps
        if self.ecfg.eos_id is not None and tok == self.ecfg.eos_id:
            self._finish(slot, "eos")
        elif len(rec.tokens) >= rec.request.max_new_tokens:
            self._finish(slot, "max_tokens")
        else:
            slot.cur_token = tok

    def _account(self, rec: RequestRecord, n: int) -> None:
        st = self._st
        ops, e_j = energy_model.token_cost(self.energy, n)
        rec.analog_ops += ops
        rec.analog_energy_j += e_j
        st.tokens_priced += n

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def _step(self, kind: str, fn, batch: dict):
        self._shapes.add((kind,) + tuple(
            (k, tuple(v.shape)) for k, v in sorted(batch.items())))
        return fn(self.params, batch, self._st.caches, self.cfg,
                  windows=self._windows)

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
        logits, st.caches = self._step("prefill", model.prefill_chunk, batch)
        st.prefill_steps += 1
        slot.prefill_done += n
        slot.pos += n
        st.prompt_tokens += n
        self._account(slot.record, n)
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
                        (new := st.pool.alloc(1)) is None:
                    self._finish(slot, "evicted")
                    continue
                slot.pages.extend(new)
            runnable.append(slot)
        if not runnable:
            return                # state changed (evictions); re-plan
        b = ecfg.slots
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
        logits, st.caches = self._step("decode", model.decode_slots, batch)
        st.decode_steps += 1
        st.util_samples.append(len(runnable) / b)
        row_logits = logits[:, 0]
        toks = torch.argmax(row_logits[:, :self.cfg.vocab_size], dim=-1).cpu()
        nans = torch.isnan(row_logits).any(dim=-1).cpu()
        for slot in runnable:              # admission order
            st.nan_steps += int(nans[slot.sid])
            slot.pos += 1
            st.generated_tokens += 1
            self._account(slot.record, 1)
            self._emit(slot, int(toks[slot.sid]))
        st.steps += 1

    # ------------------------------------------------------------------
    def report(self) -> EngineReport:
        """The report for the current (finished or in-flight) run state."""
        st = self._st
        if st is None:
            raise RuntimeError("no run state to report")
        # Aggregates are derived from the per-site attribution table, so the
        # site table sums bit-exactly to analog_ops/analog_energy_j/fj_per_op.
        attr = energy_model.site_attribution(self.energy, st.tokens_priced)
        tot_ops, tot_e = attr["ops"], attr["energy_j"]
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
        )
