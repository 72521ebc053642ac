"""Batch generation: batches of prompts, back to back, each prefilled and
then decoded greedily for ``gen`` tokens through
``models.model.prefill_step`` / ``decode_step`` over ``model.init_caches``,
as ``launch.serve.serve_static`` calls them.  Every step's tokens are read
back to the host, as a server streaming them would, and timed there.  The
window closes at the end of the step in flight when ``--seconds`` have
passed; the batch then in flight is judged on the tokens it served.  The
same rows of every batch (``sample`` of them, drawn from the seed) are
judged; the first batch's keep their served logits at every step, in a
device buffer allocated in set-up (so the window allocates nothing more).

Mix parameters: ``batch``, ``prompt_len``, ``gen``, ``zipf``, ``pool``,
``sample`` (requests judged), ``calibration``.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import traffic, work
from perfbench.drivers.base import Served, now, sync


class Driver(Served):
    kind = "decode"

    def setup(self) -> None:
        from repro_torch.models import model
        self.model = model
        self.setup_model()
        vocab = self.run["vocab_size"]
        self.prompts = [traffic.batches(self.mix, self.seed, vocab, i)
                        for i in range(self.mix["pool"])]
        self.dev_prompts = [torch.as_tensor(p, device=self.device)
                            for p in self.prompts]
        caches, logits = self._prefill(0)    # warm both shapes
        self._decode(torch.argmax(logits, -1)[:, None], caches)
        # the first batch's judged rows keep their logits here, on the
        # device and allocated before the window, at every step
        self.keep = torch.as_tensor(
            traffic.sample(self.seed, self.mix["batch"], self.mix["sample"],
                           []), device=self.device)
        self.kept = torch.empty((self.mix["gen"], len(self.keep),
                                 logits.shape[-1]), dtype=logits.dtype,
                                device=self.device)
        sync(self.device)

    def _prefill(self, i: int):
        b, s = self.mix["batch"], self.mix["prompt_len"]
        caches = self.model.init_caches(self.cfg, b, s + self.mix["gen"],
                                        self.device)
        with torch.no_grad():
            logits, caches = self.model.prefill_step(
                self.params, {"inputs": self.dev_prompts[i]}, caches,
                self.cfg, calib=self.calib)
        return caches, logits[:, -1, :self.run["vocab_size"]]

    def _decode(self, tok, caches):
        with torch.no_grad():
            logits, caches = self.model.decode_step(
                self.params, {"inputs": tok}, caches, self.cfg,
                calib=self.calib)
        return caches, logits[:, -1, :self.run["vocab_size"]]

    def window(self, rec, seconds: float) -> None:
        b, s, gen = self.mix["batch"], self.mix["prompt_len"], self.mix["gen"]
        sh, pk = self.shape, rec.peaks
        pre = work.step(sh, b * s, b * work.causal_contexts(0, s), b, pk)
        keep = self.keep
        served: list[tuple[int, list]] = []
        t0 = now()
        i, done = 0, False
        while not done:
            j = i % len(self.prompts)
            rec.attempted += b
            t = now()
            with torch.profiler.record_function("bench.prefill"):
                caches, logits = self._prefill(j)
                tok = torch.argmax(logits, -1)[:, None]
                host = tok.cpu()
            last = now()
            rec.add_step("prefill", last - t)
            rec.tokens["prefill"] = rec.tokens.get("prefill", 0) + b * s
            rec.tokens["decode"] = rec.tokens.get("decode", 0) + b
            rec.work.add(pre)
            toks = [host[:, 0].tolist()]
            if i == 0:
                self.kept[0].copy_(logits.index_select(0, keep))
            served.append((j, toks))
            for g in range(1, gen):
                if last - t0 >= seconds:
                    done = True
                    break
                with torch.profiler.record_function("bench.decode"):
                    caches, logits = self._decode(tok, caches)
                    tok = torch.argmax(logits, -1)[:, None]
                    host = tok.cpu()
                t1 = now()
                if i == 0:
                    self.kept[g].copy_(logits.index_select(0, keep))
                rec.add_step("decode", t1 - last)
                rec.itl_s.extend([t1 - last] * b)
                rec.tokens["decode"] += b
                rec.work.add(work.step(sh, b, b * (s + g), b, pk))
                toks.append(host[:, 0].tolist())
                last = t1
            i += 1
            done = done or last - t0 >= seconds
        sync(self.device)
        rec.window_s = now() - t0
        rec.samples = []
        for nb, (j, toks) in enumerate(served):
            for n, r in enumerate(keep.tolist()):
                req = {"prompt": np.asarray(self.prompts[j][r]),
                       "tokens": [step[r] for step in toks]}
                if nb == 0:
                    req["logits"] = self.kept[:len(toks), n]
                rec.samples.append(req)
