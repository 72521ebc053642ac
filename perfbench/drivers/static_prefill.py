"""Batches of prompts, back to back, each prefilled and answered with one
greedy token: ``models.model.prefill_step`` over ``model.init_caches``, as
``launch.serve.serve_static`` calls it.  The window closes at the end of
the batch in flight when ``--seconds`` have passed; a batch counts its
prompt tokens when its token reaches the host.

Mix parameters: ``batch``, ``prompt_len``, ``zipf``, ``pool`` (distinct
batches drawn from the seed and cycled), ``sample`` (requests judged),
``calibration``.  The served logits of every batch (B x V in the model's
dtype) are copied to the host for the check.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import traffic, work
from perfbench.drivers.base import Served, now, sync


class Driver(Served):
    kind = "prefill"

    def setup(self) -> None:
        from repro_torch.models import model
        self.model = model
        self.setup_model()
        vocab = self.run["vocab_size"]
        self.prompts = [traffic.batches(self.mix, self.seed, vocab, i)
                        for i in range(self.mix["pool"])]
        self.dev_prompts = [torch.as_tensor(p, device=self.device)
                            for p in self.prompts]
        self._batch(0)                       # warm the one shape
        sync(self.device)

    def _batch(self, i: int) -> torch.Tensor:
        """The batch's served logits (B, V) at the last prompt position."""
        b, s = self.mix["batch"], self.mix["prompt_len"]
        caches = self.model.init_caches(self.cfg, b, s, self.device)
        with torch.no_grad():
            logits, _ = self.model.prefill_step(
                self.params, {"inputs": self.dev_prompts[i]}, caches,
                self.cfg, calib=self.calib)
        return logits[:, -1, :self.run["vocab_size"]]

    def window(self, rec, seconds: float) -> None:
        b, s = self.mix["batch"], self.mix["prompt_len"]
        per = work.step(self.shape, b * s, b * work.causal_contexts(0, s),
                        b, rec.peaks)
        served = []
        t0 = now()
        i = 0
        while True:
            rec.attempted += b
            t = now()
            with torch.profiler.record_function("bench.prefill"):
                logits = self._batch(i % len(self.prompts))
                tok = torch.argmax(logits, -1).cpu()
            t1 = now()
            rec.add_step("prefill", t1 - t)
            rec.tokens["prefill"] = rec.tokens.get("prefill", 0) + b * s
            rec.work.add(per)
            served.append((i % len(self.prompts), tok.numpy(), logits.cpu()))
            i += 1
            if t1 - t0 >= seconds:
                break
        sync(self.device)
        rec.window_s = now() - t0
        reqs = [(j, r, int(tok[r]), lg[r:r + 1]) for j, tok, lg in served
                for r in range(b)]
        pick = traffic.sample(self.seed, len(reqs), self.mix["sample"], [])
        rec.samples = [{"prompt": np.asarray(self.prompts[reqs[k][0]]
                                             [reqs[k][1]]),
                        "tokens": [reqs[k][2]], "logits": reqs[k][3]}
                       for k in pick]
