"""Slot scheduler for the continuous-batching TD-VMM serving engine.

Requests stream in with ragged prompts, per-request token budgets, and
arrival times; the engine owns a fixed pool of B decode slots (the batch
dimension of the ONE compiled decode step).  This module is the host-side
bookkeeping: FIFO admission by (arrival_step, rid), per-slot request state,
and the deterministic iteration orders the engine relies on.

Determinism contract: the *values* a request's tokens take depend only on
the request itself (row-wise model math + pinned calibration windows), and
the *schedule* (who is admitted/evicted when) depends only on admission
sequence — never on which physical slot a request landed in.  ``slot_order``
exists to prove that: "fifo" fills the lowest free slot id, "lifo" the
highest, and the regression test asserts identical per-request streams
either way.

The static-batch baseline (``static_baseline``) models the legacy
``launch.serve.serve()`` path on the same trace: uniform batches of B in
arrival order, every sequence padded to the batch max prompt and decoded for
the batch max budget — the wall-step and utilization numbers the engine is
asserted to beat on ragged traffic.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request: prompt token ids, a decode budget, and the
    engine step at which it becomes visible to the scheduler.

    The SLA fields are inert unless the engine runs an ``runtime.sla``
    policy (defaults reproduce plain FIFO bit-identically):

    priority:       larger = more urgent; ``SlaScheduler`` ages waiting
                    requests upward so low priority never starves.
    deadline_steps: finish within this many engine steps of arrival.
                    Requests that can never make it (conservatively priced
                    on the full token budget) are rejected at admission.
    joule_budget:   per-request analog energy budget in joules (priced by
                    ``core.energy.serving_energy_model``); a request that
                    exceeds it mid-stream finishes as ``over_budget``.
    """
    rid: int
    prompt: tuple[int, ...]
    max_new_tokens: int
    arrival_step: int = 0
    priority: int = 0
    deadline_steps: Optional[int] = None
    joule_budget: Optional[float] = None

    def __post_init__(self):
        if len(self.prompt) < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens < 1")
        if self.deadline_steps is not None and self.deadline_steps < 1:
            raise ValueError(f"request {self.rid}: deadline_steps < 1")
        if self.joule_budget is not None and self.joule_budget <= 0.0:
            raise ValueError(f"request {self.rid}: joule_budget <= 0")


@dataclasses.dataclass
class RequestRecord:
    """Engine-owned mutable state + final result for one request.

    finish_reason: "eos" | "max_tokens" | "evicted" (ran out of page budget
    — the engine evicts BEFORE the overflowing cache write can happen, so an
    evicted request still streams every token it produced) | "failed" |
    "rejected" (SLA admission found the request infeasible before any
    compute) | "over_budget" (the request crossed its joule budget
    mid-stream and was finished gracefully)."""
    request: Request
    tokens: list[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    admitted_step: int = -1
    first_token_step: int = -1
    finished_step: int = -1
    analog_ops: float = 0.0
    analog_energy_j: float = 0.0
    reject_reason: Optional[str] = None

    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    @property
    def steps_in_system(self) -> int:
        return self.finished_step - self.request.arrival_step

    @property
    def deadline_hit(self) -> Optional[bool]:
        """None if the request declared no deadline; otherwise whether it
        finished (any terminal state except ``rejected``) within
        ``deadline_steps`` of arrival."""
        if self.request.deadline_steps is None:
            return None
        if self.finished_step < 0 or self.finish_reason == "rejected":
            return False
        return self.steps_in_system <= self.request.deadline_steps

    def summary(self) -> dict:
        return {
            "rid": self.request.rid,
            "prompt_len": len(self.request.prompt),
            "max_new_tokens": self.request.max_new_tokens,
            "tokens": list(self.tokens),
            "finish_reason": self.finish_reason,
            "arrival_step": self.request.arrival_step,
            "admitted_step": self.admitted_step,
            "first_token_step": self.first_token_step,
            "finished_step": self.finished_step,
            "steps_in_system": self.steps_in_system,
            "analog_ops": self.analog_ops,
            "analog_energy_j": self.analog_energy_j,
            # --- SLA outcomes -------------------------------------------
            "priority": self.request.priority,
            "deadline_steps": self.request.deadline_steps,
            "deadline_hit": self.deadline_hit,
            "joule_budget": self.request.joule_budget,
            "joules_used": self.analog_energy_j,
            "reject_reason": self.reject_reason,
        }


@dataclasses.dataclass
class Slot:
    """One occupied decode slot."""
    sid: int                  # physical batch row
    seq: int                  # admission sequence number (iteration order)
    record: RequestRecord
    pages: list[int]          # owned page ids, position order
    pos: int = 0              # tokens absorbed into the paged cache
    prefill_done: int = 0     # prompt tokens absorbed so far
    cur_token: int = -1       # next decode step's input token

    @property
    def prompt_len(self) -> int:
        return len(self.record.request.prompt)

    @property
    def prefilling(self) -> bool:
        return self.prefill_done < self.prompt_len


class SlotScheduler:
    """Fixed pool of B slots with FIFO admission by (arrival_step, rid)."""

    def __init__(self, n_slots: int, slot_order: str = "fifo"):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        if slot_order not in ("fifo", "lifo"):
            raise ValueError(f"slot_order must be fifo|lifo, got {slot_order!r}")
        self.n_slots = n_slots
        self.slot_order = slot_order
        self.slots: list[Optional[Slot]] = [None] * n_slots
        self.pending: list[Request] = []
        self._seq = 0
        self._head_idx: Optional[int] = None

    def add(self, requests) -> None:
        self.pending.extend(requests)
        self.pending.sort(key=lambda r: (r.arrival_step, r.rid))

    def has_pending(self) -> bool:
        return bool(self.pending)

    def next_arrival(self) -> Optional[int]:
        return min((r.arrival_step for r in self.pending), default=None)

    def head(self, step: int) -> Optional[Request]:
        """Next admissible request (FIFO; None if none has arrived yet).

        Subclasses override the *selection policy* only (which pending
        request is next); they must record the chosen index in
        ``self._head_idx`` so ``pop_head`` removes exactly the request the
        engine just inspected."""
        self._head_idx = None
        if self.pending and self.pending[0].arrival_step <= step:
            self._head_idx = 0
            return self.pending[0]
        return None

    def pop_head(self) -> Request:
        if self._head_idx is None:
            raise RuntimeError("pop_head without a preceding head() hit")
        req = self.pending.pop(self._head_idx)
        self._head_idx = None
        return req

    def free_slot_id(self) -> Optional[int]:
        return next(self.free_slot_ids(), None)

    def free_slot_ids(self):
        """All free slot ids in ``slot_order`` order.  Rank-partitioned
        admission (DP slot pools) walks this until it finds a slot whose
        rank's page region can satisfy the request."""
        order = range(self.n_slots) if self.slot_order == "fifo" \
            else range(self.n_slots - 1, -1, -1)
        return (sid for sid in order if self.slots[sid] is None)

    def place(self, sid: int, record: RequestRecord, pages: list[int]) -> Slot:
        assert self.slots[sid] is None
        slot = Slot(sid=sid, seq=self._seq, record=record, pages=pages)
        self._seq += 1
        self.slots[sid] = slot
        return slot

    def release(self, slot: Slot) -> None:
        assert self.slots[slot.sid] is slot
        self.slots[slot.sid] = None

    def occupied(self) -> list[Slot]:
        """Occupied slots in admission order — every engine-side iteration
        (chunk pick, eviction scan, token harvest) uses this, so scheduling
        decisions are independent of physical slot ids."""
        return sorted((s for s in self.slots if s is not None),
                      key=lambda s: s.seq)


def static_baseline(requests, n_slots: int, chunk: int) -> dict:
    """Simulate the legacy uniform-batch ``serve()`` schedule on a trace.

    Batches of ``n_slots`` in arrival order; each batch pays
    ``ceil(max_prompt / chunk)`` prefill steps (normalized to the engine's
    chunk currency) plus ``max_budget`` decode steps for *every* slot —
    the padding the paged engine exists to reclaim.  Arrival gaps are
    ignored (generous to the baseline).  Decode utilization counts a slot
    step as useful only while its request still wants tokens.
    """
    reqs = sorted(requests, key=lambda r: (r.arrival_step, r.rid))
    wall = decode_steps = useful = 0
    for i in range(0, len(reqs), n_slots):
        batch = reqs[i:i + n_slots]
        max_prompt = max(len(r.prompt) for r in batch)
        max_gen = max(r.max_new_tokens for r in batch)
        wall += -(-max_prompt // chunk) + max_gen
        decode_steps += max_gen
        useful += sum(r.max_new_tokens for r in batch)
    return {
        "wall_steps": wall,
        "decode_steps": decode_steps,
        "generated_tokens": useful,
        "utilization": useful / max(decode_steps * n_slots, 1),
        "batches": -(-len(reqs) // n_slots),
    }
