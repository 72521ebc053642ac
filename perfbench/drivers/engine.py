"""Continuous batching: a backlog of requests through
``runtime.engine.Engine`` (``start``, then ``tick`` until the window
closes), its chunked prefill and batched decode over the paged KV pools.
Every tick is timed on the host; a token is timed when the tick that
produced it returns (the engine reads each token back to the host inside
the tick, as a server streaming it would).  The window closes at the end of
the tick in flight when ``--seconds`` have passed; every request that has
served a token by then is judged on the tokens it served.

The engine's per-request token lists are read from its run state
(``Engine._st.records``): the engine has no public stream of timed tokens.

Mix parameters: ``slots``, ``chunk``, ``page_size``, ``prompt_len`` and
``output_len`` (length distributions), ``per_round``, ``rounds``, ``zipf``,
``calibration``.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import traffic, work
from perfbench.drivers.base import Served, now, sync


class Driver(Served):
    kind = "decode"

    def setup(self) -> None:
        from repro_torch.runtime import engine as eng
        from repro_torch.runtime.paged_cache import pages_for
        from repro_torch.runtime.scheduler import Request
        self.Request = Request
        self.setup_model()
        mix = self.mix
        longest = mix["prompt_len"]["hi"] + mix["output_len"]["hi"]
        per_slot = pages_for(longest, mix["page_size"])
        self.engine = eng.Engine(
            self.cfg, self.params,
            eng.EngineConfig(slots=mix["slots"], page_size=mix["page_size"],
                             num_pages=per_slot * mix["slots"],
                             chunk=mix["chunk"], max_pages_per_slot=per_slot),
            calib=self.calib, device=self.device)
        self.reqs = traffic.requests(mix, self.seed, self.run["vocab_size"])
        # warm both step programs: one chunk, then one decode step
        warm = self.reqs[0]["prompt"][:mix["chunk"]]
        self.engine.start([Request(rid=0, prompt=tuple(int(t) for t in warm),
                                   max_new_tokens=2)])
        while self.engine.tick():
            pass
        sync(self.device)

    def window(self, rec, seconds: float) -> None:
        eng, sh, pk = self.engine, self.shape, rec.peaks
        self.engine.start([self.Request(
            rid=r["rid"], prompt=tuple(int(t) for t in r["prompt"]),
            max_new_tokens=r["max_new"]) for r in self.reqs])
        seen: dict[int, tuple[int, float]] = {}
        plen = {r["rid"]: len(r["prompt"]) for r in self.reqs}
        t0 = now()
        while True:
            st = eng._st
            pre0, dec0 = st.prefill_steps, st.decode_steps
            done0 = {s.record.request.rid: s.prefill_done
                     for s in st.sched.occupied()}
            with torch.profiler.record_function("bench.tick"):
                t = now()
                more = eng.tick()
                t1 = now()
            rec.add_step("tick", t1 - t)
            fresh, new = {}, 0
            for rid, r in st.records.items():
                n = len(r.tokens)
                old_n, old_t = seen.get(rid, (0, None))
                if n > old_n:
                    if old_t is not None:
                        rec.itl_s.extend([t1 - old_t] * (n - old_n))
                    fresh[rid] = old_n
                    new += n - old_n
                    seen[rid] = (n, t1)
            rec.tokens["decode"] = rec.tokens.get("decode", 0) + new
            if st.prefill_steps > pre0:
                # the slot whose prompt advanced: its chunk's valid tokens,
                # the head only where the chunk ends the prompt
                after = {s.record.request.rid: s.prefill_done
                         for s in st.sched.occupied()}
                for rid, a in done0.items():
                    b = after.get(rid, plen[rid])
                    if a < plen[rid] and b > a:
                        rec.work.add(work.step(
                            sh, b - a, work.causal_contexts(a, b - a),
                            int(rid in fresh), pk))
            if st.decode_steps > dec0:
                rows = [rid for rid, old_n in fresh.items() if old_n > 0]
                rec.work.add(work.step(
                    sh, len(rows), sum(plen[rid] + fresh[rid]
                                       for rid in rows), len(rows), pk))
            if not more or t1 - t0 >= seconds:
                break
        sync(self.device)
        rec.window_s = now() - t0
        st = eng._st
        rec.attempted = sum(1 for r in st.records.values()
                            if r.admitted_step >= 0)
        rec.failed = sum(1 for r in st.records.values()
                         if r.finish_reason in ("failed", "evicted",
                                                "rejected"))
        rec.tokens["prefill"] = st.prompt_tokens
        by_rid = {r["rid"]: r for r in self.reqs}
        rec.samples = [{"prompt": np.asarray(by_rid[rid]["prompt"]),
                        "tokens": list(r.tokens)}
                       for rid, r in sorted(st.records.items()) if r.tokens]

    def release(self) -> dict:
        self.engine = None                   # its page pools and windows
        return super().release()
