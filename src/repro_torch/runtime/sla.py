"""SLA-aware admission and dispatch for the serving engine — the port's
copy of ``repro.runtime.sla``.

The paper's headline is an energy *budget* (~7 fJ/Op at N > 200), and per-
request joule budgets only mean something if they are enforced while
traffic is live.  This module layers an SLA policy over the engine's
``SlotScheduler``:

  * **Priority with aging** (``SlaScheduler``): admission picks the
    pending request with the highest *effective* priority
    ``priority + waited // aging_steps`` — every ``aging_steps`` of queue
    wait promotes a request one level, so with priorities bounded by
    ``P_max`` a lowest-priority request outranks every fresh arrival after
    at most ``(P_max + 1) * aging_steps`` waited steps (``wait_bound``).
    Ties break (arrival_step, rid) — with every priority at the default 0
    the selection IS plain FIFO, so SLA-disabled traces replay exactly.
  * **Deadline admission control**: a request whose deadline can no longer
    be met even with immediate exclusive service — conservatively priced on
    its full token budget at one chunk/token per engine step — is rejected
    AT ADMISSION, before any compute touches it (``finish_reason ==
    "rejected"``, zero tokens, zero joules).
  * **Joule admission control**: a request whose *minimum* possible work
    (prompt prefill + one generated token, priced by
    ``core.energy.serving_energy_model`` over the resolved plan) already
    exceeds its ``joule_budget`` can never stream a token within budget —
    rejected at admission.  Requests that pass admission but cross their
    budget mid-stream are finished as ``over_budget`` by the engine (the
    same path as a persistent step failure: pages freed, neighbours'
    streams unchanged).

Everything here is host-side bookkeeping between the two step programs
(``step_shapes == 2`` holds through any SLA-scheduled run), and the
selection depends only on (pending set, engine step) — never on physical
slot ids — so the streams do not depend on the slot order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core import energy as energy_model
from repro_torch.runtime.scheduler import Request, SlotScheduler

__all__ = ["SlaConfig", "SlaScheduler", "admission_verdict",
           "min_steps_to_finish", "wait_bound"]


@dataclasses.dataclass(frozen=True)
class SlaConfig:
    """SLA policy knobs for one engine.

    aging_steps: queue-wait steps per priority level of aging (the
                 no-starvation lever; must be >= 1).  Deadline and joule
                 admission control always apply.
    """
    aging_steps: int = 16

    def __post_init__(self):
        if self.aging_steps < 1:
            raise ValueError(f"aging_steps must be >= 1, got "
                             f"{self.aging_steps}")


class SlaScheduler(SlotScheduler):
    """Priority-with-aging admission over the fixed slot pool.

    Selection is a pure function of (pending requests, engine step):
    deterministic, replayable from a snapshot's pending list, and
    independent of slot assignment order."""

    def __init__(self, n_slots: int, slot_order: str = "fifo",
                 sla: SlaConfig = SlaConfig()):
        super().__init__(n_slots, slot_order)
        self.sla = sla

    def effective_priority(self, req: Request, step: int) -> int:
        waited = max(0, step - req.arrival_step)
        return req.priority + waited // self.sla.aging_steps

    def head(self, step: int) -> Optional[Request]:
        """Highest effective priority among arrived requests; ties break
        (arrival_step, rid) so equal-priority traffic stays FIFO."""
        self._head_idx = None
        best = None
        for i, r in enumerate(self.pending):
            if r.arrival_step > step:
                continue
            key = (-self.effective_priority(r, step), r.arrival_step, r.rid)
            if best is None or key < best[0]:
                best = (key, i)
        if best is None:
            return None
        self._head_idx = best[1]
        return self.pending[self._head_idx]


def min_steps_to_finish(req: Request, chunk: int) -> int:
    """Engine steps from admission to finish under immediate exclusive
    service: ``ceil(prompt / chunk)`` prefill chunks (the last one emits the
    first token) plus one decode step per remaining token.  Conservative on
    purpose — an early ``eos`` could finish sooner, but admission cannot
    know that, so deadlines are priced on the full budget."""
    chunks = -(-len(req.prompt) // chunk)
    return chunks + req.max_new_tokens - 1


def admission_verdict(req: Request, step: int, chunk: int,
                      energy: dict) -> Optional[str]:
    """None = admit; otherwise the rejection reason.

    Called by the engine at the moment a request would occupy a slot —
    BEFORE any pages are allocated or any step program sees its tokens.
    ``energy`` is the engine's ``serving_energy_model`` table, so the joule
    check prices the request over the resolved plan's tile geometry."""
    if req.deadline_steps is not None:
        # Finishing at step s means finished_step == s; admission at `step`
        # can at best start prefill this same step.
        min_finish = step + min_steps_to_finish(req, chunk) - 1
        if min_finish - req.arrival_step > req.deadline_steps:
            return (f"deadline-infeasible: earliest finish "
                    f"{min_finish - req.arrival_step} steps after arrival "
                    f"> deadline {req.deadline_steps}")
    if req.joule_budget is not None:
        bounds = energy_model.request_energy_bounds(
            energy, len(req.prompt), req.max_new_tokens)
        if bounds["min_energy_j"] > req.joule_budget:
            return (f"joule-infeasible: minimum work "
                    f"{bounds['min_energy_j']:.3g} J (prompt + 1 token) "
                    f"> budget {req.joule_budget:.3g} J")
    return None


def wait_bound(sla: SlaConfig, max_priority: int, min_priority: int = 0) -> int:
    """Steps after which a ``min_priority`` request's effective priority
    strictly exceeds ``max_priority`` — from then on it outranks every
    fresh arrival (the aging no-starvation bound the fairness test
    asserts)."""
    if math.isinf(max_priority):
        raise ValueError("unbounded priorities cannot bound waiting")
    levels = max_priority - min_priority + 1
    return levels * sla.aging_steps
