"""The reference against the port at a small size on the CPU: a whole run of
each driver (set-up, window, check) comes out correct, and comes out not
correct when the timed path is broken underneath: a token altered where it
is produced, a step that returns its state unchanged, half of the batch
left out.  The look for a card is skipped (``run_cell`` on the CPU)."""
import time

import pytest
import torch

from perfbench import harness

SMALL = dict(d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
             vocab_size=512, top_k=2, expert_d_ff=32, dtype="float32")
MIXES = {
    "mixtral.prefill-8x1024": dict(batch=2, prompt_len=16, pool=3,
                                   calibration={"batch": 2, "len": 16}),
    "mixtral.decode-16x256": dict(batch=2, prompt_len=8, gen=6, pool=2,
                                  sample=3,
                                  calibration={"batch": 2, "len": 8}),
    "kimi.engine-chat": dict(slots=3, chunk=8, page_size=4,
                             prompt_len={"dist": "loguniform", "lo": 4,
                                         "hi": 20},
                             output_len={"dist": "uniform", "lo": 3,
                                         "hi": 8},
                             per_round=3, rounds=2,
                             calibration={"batch": 2, "len": 12}),
}
SEED = 2**31 + 12345
# A fault in a decode step shows only once the window holds decode steps
# after the first; this window holds several even on a CPU shared with
# other test runs.
FAULT_SECONDS = 3.0


def small_cell(name: str):
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.resolve(name, bench)
    r = cell.run
    r.update(SMALL, n_experts=8 if r["n_shared_experts"] else 4)
    r["capacity_factor"] = r["n_experts"] / r["top_k"]
    cell.mix.update(MIXES[name])
    return bench, cell


def run(name: str, patch=None, seconds: float = 1.0) -> dict:
    bench, cell = small_cell(name)
    return harness.run_cell(name, SEED, seconds, False, time.time(),
                            device="cpu", cell=cell, bench=bench,
                            driver_patch=patch)


def altered(model):
    """The model module with every step's greedy token moved off its
    argmax (the logits of the next token raised above the best)."""
    class Altered:
        def __getattr__(self, k):
            return getattr(model, k)

        @staticmethod
        def _alter(out):
            logits, caches = out
            best = logits.argmax(-1, keepdim=True)
            bump = torch.zeros_like(logits).scatter_(
                -1, (best + 1) % logits.shape[-1], 1e4)
            return logits + bump, caches

        def prefill_step(self, *a, **k):
            return self._alter(model.prefill_step(*a, **k))

        def decode_step(self, *a, **k):
            return self._alter(model.decode_step(*a, **k))

        def prefill_chunk(self, *a, **k):
            return self._alter(model.prefill_chunk(*a, **k))

        def decode_slots(self, *a, **k):
            return self._alter(model.decode_slots(*a, **k))
    return Altered()


@pytest.mark.parametrize("name", sorted(MIXES))
def test_sound_run_is_correct(name):
    res = run(name)
    assert res["correct"], res["why_not_correct"]
    assert res["reference"]["readings"]["gap_max"] == 0.0
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("name", ["mixtral.prefill-8x1024",
                                  "mixtral.decode-16x256"])
def test_altered_token_is_not_correct(name):
    def patch(drv):
        drv.model = altered(drv.model)
    res = run(name, patch)
    assert not res["correct"]


def test_engine_altered_token_is_not_correct(monkeypatch):
    from repro_torch.runtime import engine
    monkeypatch.setattr(engine, "model", altered(engine.model))
    assert not run("kimi.engine-chat")["correct"]


def test_decode_state_unchanged_is_not_correct():
    def patch(drv):
        model = drv.model

        class Stale:
            def __getattr__(self, k):
                return getattr(model, k)

            def decode_step(self, params, batch, caches, cfg, calib=None):
                copy = type(caches["seg0"])(*(
                    None if t is None else t.clone()
                    for t in caches["seg0"]))
                logits, _ = model.decode_step(params, batch,
                                              {"seg0": copy}, cfg, calib)
                return logits, caches          # the cache never advances
        drv.model = Stale()
    assert not run("mixtral.decode-16x256", patch, FAULT_SECONDS)["correct"]


def test_half_batch_left_out_is_not_correct():
    def patch(drv):
        model = drv.model

        class Half:
            def __getattr__(self, k):
                return getattr(model, k)

            def prefill_step(self, params, batch, caches, cfg, calib=None):
                x = batch["inputs"]
                h = x.shape[0] // 2
                half = model.init_caches(cfg, h, x.shape[1], x.device)
                logits, _ = model.prefill_step(params, {"inputs": x[:h]},
                                               half, cfg, calib)
                fill = logits.mean(0, keepdim=True).expand(
                    x.shape[0] - h, *logits.shape[1:])
                return torch.cat([logits, fill]), caches
        drv.model = Half()
    assert not run("mixtral.prefill-8x1024", patch)["correct"]


def _stale(step):
    """``step`` run on a copy of the caches, the caches returned as they
    came: the step leaves its state unchanged."""
    def run(params, batch, caches, cfg, *a, **k):
        copy = {name: type(c)(*(None if t is None else t.clone() for t in c))
                for name, c in caches.items()}
        logits, _ = step(params, batch, copy, cfg, *a, **k)
        return logits, caches
    return run


def _half(step):
    """``step`` on the first half of the batch's rows; the other half's
    logits the mean of the first's."""
    def run(params, batch, caches, cfg, *a, **k):
        logits, caches = step(params, batch, caches, cfg, *a, **k)
        h = logits.shape[0] // 2
        fill = logits[:h].mean(0, keepdim=True).expand(
            logits.shape[0] - h, *logits.shape[1:])
        return torch.cat([logits[:h], fill]), caches
    return run


@pytest.mark.parametrize("fault,step", [(_stale, "prefill_chunk"),
                                        (_half, "decode_slots")])
def test_engine_fault_is_not_correct(monkeypatch, fault, step):
    from repro_torch.runtime import engine
    model = engine.model

    class Broken:
        def __getattr__(self, k):
            return getattr(model, k)
    broken = Broken()
    setattr(broken, step, fault(getattr(model, step)))
    monkeypatch.setattr(engine, "model", broken)
    assert not run("kimi.engine-chat", seconds=FAULT_SECONDS)["correct"]
