"""The port's continuous-batching engine: the same token streams as the JAX
package's engine on a ragged trace, batched == solo, pinned windows
required, evict-before-poison."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import TDVMMPlan as JPlan
from repro.configs import get_config as jget
from repro.configs import smoke as jsmoke
from repro.configs import tdvmm_rule as jrule
from repro.models import model as jmodel
from repro.runtime import engine as jengine
from repro_torch import convert
from repro_torch.configs import TDVMMPlan as TPlan
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke as tsmoke
from repro_torch.configs import tdvmm_rule as trule
from repro_torch.core.calibration import CalibrationState
from repro_torch.runtime.engine import Engine, EngineConfig, Request


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


@functools.lru_cache(maxsize=None)
def _served(chain: bool):
    """(jax cfg, port cfg, jax params, port params, jax calib, port calib)."""
    jr = [jrule("ffn.*", enabled=True, backend="jnp")]
    tr = [trule("ffn.*", enabled=True)]
    if chain:
        jr.append(jrule("ffn.in", chain=True))
        tr.append(trule("ffn.in", chain=True))
    jc = jsmoke(jget("qwen1.5-0.5b")).replace(tdvmm_plan=JPlan(tuple(jr)))
    tc = tsmoke(tget("qwen1.5-0.5b")).replace(tdvmm_plan=TPlan(tuple(tr)))
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jc)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), tc,
                                        "cpu")
    batch = {"inputs": jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0,
                                          jc.vocab_size)}
    jcal = jmodel.calibrate(jparams, batch, jc, max_len=48)
    tcal = CalibrationState(windows={
        s: torch.from_numpy(np.array(v, np.float32))
        for s, v in jcal.windows.items()})
    return jc, tc, jparams, tparams, jcal, tcal


def _trace(vocab, n=4, seed=0, prompt=(3, 11), gen=(2, 6), max_gap=0):
    """The ragged trace of the JAX package's engine tests."""
    rng = np.random.default_rng(seed)
    reqs, arrival = [], 0
    for rid in range(n):
        reqs.append(dict(
            rid=rid,
            prompt=tuple(int(t) for t in rng.integers(
                0, vocab, rng.integers(*prompt))),
            max_new_tokens=int(rng.integers(*gen)),
            arrival_step=arrival))
        arrival += int(rng.integers(0, max_gap + 1))
    return reqs


ECFG = dict(slots=3, page_size=4, num_pages=32, chunk=16)


@pytest.mark.parametrize("chain", [False, True])
def test_engine_streams_match_reference_engine(chain):
    jc, tc, jparams, tparams, jcal, tcal = _served(chain)
    trace = _trace(jc.vocab_size, n=4)
    jrep = jengine.Engine(jc, jparams, jengine.EngineConfig(**ECFG),
                          calib=jcal).run([jengine.Request(**r) for r in trace])
    trep = Engine(tc, tparams, EngineConfig(**ECFG), calib=tcal,
                  device="cpu").run([Request(**r) for r in trace])
    assert trep.step_shapes == 2
    assert trep.nan_logit_steps == 0
    for a, b in zip(trep.requests, jrep.requests):
        assert a["finish_reason"] == b["finish_reason"] == "max_tokens"
        assert a["tokens"] == b["tokens"]
        assert a["finished_step"] == b["finished_step"]
    for key in ("steps", "prefill_steps", "decode_steps", "generated_tokens",
                "page_high_water", "analog_ops", "analog_energy_j",
                "fj_per_op"):
        assert getattr(trep, key) == getattr(jrep, key), key


@pytest.mark.parametrize("slot_order", ["fifo", "lifo"])
def test_batched_equals_solo_with_chunked_prefill(slot_order):
    """Chunked prefill (chunk < prompt) stays request-isolated: batched run
    == each request alone through an engine of the same config."""
    _, tc, _, tparams, _, tcal = _served(False)
    trace = [Request(**r) for r in _trace(tc.vocab_size, n=5, seed=3,
                                          prompt=(6, 14), max_gap=1)]
    ecfg = EngineConfig(slots=3, page_size=4, num_pages=32, chunk=4,
                        slot_order=slot_order)
    rep = Engine(tc, tparams, ecfg, calib=tcal, device="cpu").run(trace)
    assert rep.step_shapes == 2
    for req, rec in zip(trace, rep.requests):
        solo = Engine(tc, tparams, ecfg, calib=tcal, device="cpu").run(
            [Request(req.rid, req.prompt, req.max_new_tokens, 0)])
        assert rec["tokens"] == solo.requests[0]["tokens"]


def test_engine_requires_pinned_windows():
    _, tc, _, tparams, _, _ = _served(False)
    with pytest.raises(ValueError, match="pinned readout window"):
        Engine(tc, tparams, EngineConfig(), device="cpu")


def test_eviction_finishes_cleanly_without_poisoning_neighbors():
    _, tc, _, tparams, _, tcal = _served(False)
    reqs = [Request(0, tuple(range(1, 9)), max_new_tokens=40),
            Request(1, tuple(range(9, 14)), max_new_tokens=4),
            Request(2, tuple(range(14, 20)), max_new_tokens=5)]
    ecfg = EngineConfig(slots=3, page_size=4, num_pages=16,
                        max_pages_per_slot=3, chunk=16)
    rep = Engine(tc, tparams, ecfg, calib=tcal, device="cpu").run(reqs)
    by_rid = {r["rid"]: r for r in rep.requests}
    # budget = 3 pages * 4 = 12 positions, prompt 8 -> 4 decode writes; the
    # token sampled after the last write needs no page, so 5 tokens stream.
    assert by_rid[0]["finish_reason"] == "evicted"
    assert len(by_rid[0]["tokens"]) == 5
    assert rep.nan_logit_steps == 0
    solo_cfg = EngineConfig(slots=3, page_size=4, num_pages=16, chunk=16)
    for rid, n in ((0, 5), (1, 4), (2, 5)):
        solo = Engine(tc, tparams, solo_cfg, calib=tcal, device="cpu").run(
            [Request(rid, reqs[rid].prompt, n)])
        assert by_rid[rid]["tokens"] == solo.requests[0]["tokens"]
    assert by_rid[1]["finish_reason"] == by_rid[2]["finish_reason"] \
        == "max_tokens"


def test_oversized_prompt_rejected_as_evicted():
    _, tc, _, tparams, _, tcal = _served(True)
    reqs = [Request(0, tuple(range(1, 30)), max_new_tokens=4),
            Request(1, tuple(range(1, 6)), max_new_tokens=3)]
    ecfg = EngineConfig(slots=2, page_size=4, num_pages=16,
                        max_pages_per_slot=4, chunk=8)
    rep = Engine(tc, tparams, ecfg, calib=tcal, device="cpu").run(reqs)
    assert rep.requests[0]["finish_reason"] == "evicted"
    assert rep.requests[0]["tokens"] == []
    assert rep.requests[1]["finish_reason"] == "max_tokens"
    assert rep.evictions == 1
