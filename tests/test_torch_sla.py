"""The port's SLA policy against the JAX package's: priority-with-aging head
selections, admission verdicts, the deadline pricing and the energy bounds
equal module against module on seeded inputs; an SLA-scheduled port engine
(priorities, a deadline-infeasible request, a joule budget crossed
mid-stream) streams, rejects, finishes and counts as the JAX engine does;
and the port's engine on its own (tests/test_sla.py's engine tests):
default SLA == FIFO, LIFO slots, the aging bound, rejections cost
nothing, priority reorders admission and not tokens, kill and resume."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import TDVMMPlan as JPlan
from repro.configs import get_config as jget
from repro.configs import smoke as jsmoke
from repro.configs import tdvmm_rule as jrule
from repro.core import energy as jenergy
from repro.models import model as jmodel
from repro.runtime import engine as jengine
from repro.runtime import scheduler as jsched
from repro.runtime import sla as jsla
from repro_torch import convert
from repro_torch.configs import TDVMMPlan as TPlan
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke as tsmoke
from repro_torch.configs import tdvmm_rule as trule
from repro_torch.core import energy
from repro_torch.core.calibration import CalibrationState
from repro_torch.runtime import faultinject as fi
from repro_torch.runtime import sla
from repro_torch.runtime.engine import (Engine, EngineConfig, FaultConfig,
                                        Request)


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


ECFG = dict(slots=3, page_size=4, num_pages=32, chunk=4)


@functools.lru_cache(maxsize=None)
def _served():
    """(jax cfg, port cfg, jax params, port params, jax calib, port calib)
    of the smoke qwen under ``ffn.*``."""
    jc = jsmoke(jget("qwen1.5-0.5b")).replace(tdvmm_plan=JPlan(
        (jrule("ffn.*", enabled=True, backend="jnp"),)))
    tc = tsmoke(tget("qwen1.5-0.5b")).replace(tdvmm_plan=TPlan(
        (trule("ffn.*", enabled=True),)))
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


def _energy_tables():
    jc, tc, *_ = _served()
    return (energy.serving_energy_model(tc, 256),
            jenergy.serving_energy_model(jc, 256))


def _random_requests(seed: int, n: int = 24, e_tok: float = 6e-12):
    """Seeded request fields: ragged prompts and budgets, priorities 0-3,
    arrivals over 12 steps, some deadlines and joule budgets (of 1-60
    tokens' energy ``e_tok``)."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        out.append(dict(
            rid=int(rng.permutation(1000)[rid]),
            prompt=tuple(int(t) for t in rng.integers(1, 50, rng.integers(1, 40))),
            max_new_tokens=int(rng.integers(1, 30)),
            arrival_step=int(rng.integers(0, 12)),
            priority=int(rng.integers(0, 4)),
            deadline_steps=(int(rng.integers(1, 60)) if rng.random() < 0.6
                            else None),
            joule_budget=(float(e_tok * rng.uniform(1.0, 60.0))
                          if rng.random() < 0.6 else None)))
    return out


# --------------------------------------------------------------------------
# Module against module
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed, aging", [(0, 1), (1, 4), (2, 16), (3, 3)])
def test_head_selections_equal_reference(seed, aging):
    """Two schedulers over the same pending set, one admission a step plus
    a fresh arrival now and then: the same request at every head()."""
    fields = _random_requests(seed)
    mine = sla.SlaScheduler(2, sla=sla.SlaConfig(aging_steps=aging))
    ref = jsla.SlaScheduler(2, sla=jsla.SlaConfig(aging_steps=aging))
    mine.add([Request(**f) for f in fields[:16]])
    ref.add([jsched.Request(**f) for f in fields[:16]])
    order = []
    for step in range(40):
        if step % 5 == 0 and fields[16:]:
            f = dict(fields.pop(16), arrival_step=step)
            mine.add([Request(**f)])
            ref.add([jsched.Request(**f)])
        a, b = mine.head(step), ref.head(step)
        assert (a and a.rid) == (b and b.rid), step
        if a is not None:
            assert mine.effective_priority(a, step) == \
                ref.effective_priority(b, step)
            order.append(mine.pop_head().rid)
            ref.pop_head()
    assert len(order) > 10 and not mine.pending and not ref.pending
    with pytest.raises(RuntimeError, match="pop_head"):
        mine.pop_head()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_verdicts_equal_reference(seed):
    """The verdict strings of the port and of the JAX package (at its
    default policy, both checks on) on the same requests, steps, chunks and
    energy tables (the smoke qwen's)."""
    table, jtable = _energy_tables()
    assert table == jtable
    verdicts = set()
    for f in _random_requests(seed, e_tok=table["energy_per_token_j"]):
        for step in (f["arrival_step"], f["arrival_step"] + 7, 40):
            for chunk in (4, 16):
                a = sla.admission_verdict(Request(**f), step, chunk, table)
                b = jsla.admission_verdict(jsched.Request(**f), step, chunk,
                                           jtable, jsla.SlaConfig())
                assert a == b, (f, step, chunk)
                verdicts.add(None if a is None else a.split(":")[0])
    assert verdicts == {None, "deadline-infeasible", "joule-infeasible"}


def test_pricing_bounds_and_config_equal_reference():
    table, jtable = _energy_tables()
    for f in _random_requests(4):
        r, jr = Request(**f), jsched.Request(**f)
        for chunk in (1, 4, 32):
            assert sla.min_steps_to_finish(r, chunk) == \
                jsla.min_steps_to_finish(jr, chunk)
        assert energy.request_energy_bounds(
            table, len(r.prompt), r.max_new_tokens) == \
            jenergy.request_energy_bounds(jtable, len(r.prompt),
                                          r.max_new_tokens)
    for aging, pmax in ((1, 0), (4, 2), (16, 5)):
        assert sla.wait_bound(sla.SlaConfig(aging_steps=aging), pmax) == \
            jsla.wait_bound(jsla.SlaConfig(aging_steps=aging), pmax)
    with pytest.raises(ValueError, match="unbounded"):
        sla.wait_bound(sla.SlaConfig(), max_priority=float("inf"))
    with pytest.raises(ValueError, match="aging_steps"):
        sla.SlaConfig(aging_steps=0)
    with pytest.raises(ValueError, match=">= 1"):
        energy.request_energy_bounds(table, 0, 1)
    assert sla.SlaConfig() == sla.SlaConfig(aging_steps=16)


# --------------------------------------------------------------------------
# Engine against engine
# --------------------------------------------------------------------------
def _sla_trace(vocab, e_tok):
    """Six ragged requests with priorities rid % 3, then a request whose
    deadline is infeasible at admission and one whose joule budget passes
    admission but runs out mid-stream."""
    rng = np.random.default_rng(0)
    reqs, arrival = [], 0
    for rid in range(6):
        reqs.append(dict(
            rid=rid,
            prompt=tuple(int(t) for t in rng.integers(
                0, vocab, rng.integers(3, 11))),
            max_new_tokens=int(rng.integers(2, 6)),
            arrival_step=arrival, priority=rid % 3,
            deadline_steps=40))
        arrival += int(rng.integers(0, 2))
    capped = tuple(range(1, 7))
    reqs.append(dict(rid=900, prompt=tuple(range(1, 9)), max_new_tokens=20,
                     arrival_step=1, deadline_steps=3))
    reqs.append(dict(rid=901, prompt=capped, max_new_tokens=6, arrival_step=2,
                     priority=1, joule_budget=(len(capped) + 2.5) * e_tok))
    return reqs


@functools.lru_cache(maxsize=None)
def _sla_runs():
    """(trace, JAX report, port report) under SlaConfig(aging_steps=4)."""
    jc, tc, jparams, tparams, jcal, tcal = _served()
    table, _ = _energy_tables()
    trace = _sla_trace(jc.vocab_size, table["energy_per_token_j"])
    jrep = jengine.Engine(jc, jparams, jengine.EngineConfig(**ECFG),
                          calib=jcal, sla=jsla.SlaConfig(aging_steps=4)).run(
        [jengine.Request(**r) for r in trace])
    trep = Engine(tc, tparams, EngineConfig(**ECFG), calib=tcal,
                  sla=sla.SlaConfig(aging_steps=4), device="cpu").run(
        [Request(**r) for r in trace])
    return trace, jrep, trep


def test_sla_engine_equals_reference_engine():
    _, jrep, trep = _sla_runs()
    keys = ("rid", "tokens", "finish_reason", "reject_reason",
            "admitted_step", "first_token_step", "finished_step",
            "deadline_hit", "priority", "analog_ops", "joules_used")
    for a, b in zip(jrep.requests, trep.requests):
        assert {k: a[k] for k in keys} == {k: b[k] for k in keys}, (a, b)
    for k in ("steps", "rejected", "over_budget", "deadline_hits",
              "deadline_misses", "generated_tokens", "tokens_priced",
              "evictions", "analog_ops", "analog_energy_j"):
        assert getattr(trep, k) == getattr(jrep, k), k
    by_rid = {r["rid"]: r for r in trep.requests}
    assert by_rid[900]["finish_reason"] == "rejected"
    assert "deadline-infeasible" in by_rid[900]["reject_reason"]
    assert by_rid[901]["finish_reason"] == "over_budget"
    assert trep.rejected == 1 and trep.over_budget == 1
    assert trep.step_shapes == 2


def test_sla_admission_order_follows_priority():
    trace, _, trep = _sla_runs()
    by_rid = {r["rid"]: r for r in trep.requests}
    plain = _engine().run([Request(**{**r, "priority": 0}) for r in trace])
    # the priorities moved someone's admission ...
    assert [by_rid[r["rid"]]["admitted_step"] for r in trace] != \
        [r["admitted_step"] for r in plain.requests]
    # ... and no admitted request's token values
    plain_by = {r["rid"]: r for r in plain.requests}
    for rid, rec in by_rid.items():
        if rec["finish_reason"] == "max_tokens":
            assert rec["tokens"] == plain_by[rid]["tokens"], rid


# --------------------------------------------------------------------------
# The port's engine on its own (tests/test_sla.py's engine tests)
# --------------------------------------------------------------------------
def _engine(slot_order="fifo", slots=3, **kw):
    _, tc, _, tparams, _, tcal = _served()
    ecfg = EngineConfig(**{**ECFG, "slots": slots, "slot_order": slot_order})
    return Engine(tc, tparams, ecfg, calib=tcal, device="cpu", **kw)


def _trace(vocab, n=4, seed=0, **fields):
    rng = np.random.default_rng(seed)
    reqs, arrival = [], 0
    for rid in range(n):
        reqs.append(Request(
            rid=rid,
            prompt=tuple(int(t) for t in rng.integers(
                0, vocab, rng.integers(3, 11))),
            max_new_tokens=int(rng.integers(2, 6)),
            arrival_step=arrival, **fields))
        arrival += int(rng.integers(0, 2))
    return reqs


def _same_streams(a, b):
    for ra, rb in zip(a.requests, b.requests):
        assert ra["tokens"] == rb["tokens"], (ra, rb)
        assert ra["finish_reason"] == rb["finish_reason"], (ra, rb)
        assert ra["finished_step"] == rb["finished_step"], (ra, rb)
    assert a.steps == b.steps


def test_default_sla_replays_fifo_exactly():
    _, tc, *_ = _served()
    reqs = _trace(tc.vocab_size, n=6, seed=3)
    base = _engine().run(reqs)
    rep = _engine(sla=sla.SlaConfig()).run(reqs)
    _same_streams(base, rep)
    assert [r["admitted_step"] for r in rep.requests] == \
        [r["admitted_step"] for r in base.requests]
    assert rep.step_shapes == 2 and rep.rejected == rep.over_budget == 0


def test_lifo_slot_order_identical_streams_under_sla():
    _, tc, *_ = _served()
    reqs = [Request(rid=r.rid, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens,
                    arrival_step=r.arrival_step, priority=r.rid % 3)
            for r in _trace(tc.vocab_size, n=5, seed=2)]
    fifo = _engine(sla=sla.SlaConfig(aging_steps=8)).run(reqs)
    lifo = _engine("lifo", sla=sla.SlaConfig(aging_steps=8)).run(reqs)
    _same_streams(fifo, lifo)


def test_aging_bounds_the_wait_in_the_engine():
    """One slot, a low-priority request and a high-priority one arriving
    every step: the low one is admitted within wait_bound of its arrival;
    with aging in effect off it waits for the whole flood."""
    _, tc, *_ = _served()
    cfg = sla.SlaConfig(aging_steps=2)
    low = Request(rid=0, prompt=(5, 6, 7), max_new_tokens=1, priority=0)
    flood = [Request(rid=100 + i, prompt=(8, 9), max_new_tokens=1,
                     arrival_step=i, priority=2) for i in range(12)]
    rep = _engine(slots=1, sla=cfg).run([low] + flood)
    by_rid = {r["rid"]: r for r in rep.requests}
    bound = sla.wait_bound(cfg, max_priority=2)
    assert bound == 6
    assert by_rid[0]["admitted_step"] <= bound
    assert by_rid[0]["admitted_step"] > 0              # it did wait
    starved = _engine(slots=1, sla=sla.SlaConfig(aging_steps=10_000)).run(
        [low] + flood)
    assert {r["rid"]: r for r in starved.requests}[0]["admitted_step"] > \
        max(r["admitted_step"] for r in starved.requests if r["rid"] != 0) - 1


def test_rejections_cost_nothing():
    """A deadline- and a joule-infeasible request: no slot, no page, no
    token, no joule; the rest of the run is the run without them."""
    _, tc, *_ = _served()
    reqs = _trace(tc.vocab_size, n=4, seed=0)
    e_tok = _engine().energy["energy_per_token_j"]
    doomed = Request(rid=900, prompt=tuple(range(1, 9)), max_new_tokens=20,
                     deadline_steps=1)
    poor = Request(rid=901, prompt=tuple(range(1, 7)), max_new_tokens=4,
                   joule_budget=3 * e_tok)
    base = _engine(sla=sla.SlaConfig()).run(reqs)
    rep = _engine(sla=sla.SlaConfig()).run(reqs + [doomed, poor])
    by_rid = {r["rid"]: r for r in rep.requests}
    for rid, why in ((900, "deadline-infeasible"), (901, "joule-infeasible")):
        rec = by_rid[rid]
        assert rec["finish_reason"] == "rejected" and why in rec["reject_reason"]
        assert rec["tokens"] == [] and rec["first_token_step"] == -1
        assert rec["analog_ops"] == 0.0 and rec["joules_used"] == 0.0
        assert rec["admitted_step"] == rec["finished_step"] == 0
    assert by_rid[900]["deadline_hit"] is False
    assert rep.rejected == 2 and rep.deadline_misses == 0
    _same_streams(base, rep)
    assert rep.tokens_priced == base.tokens_priced
    assert rep.page_high_water == base.page_high_water


def test_deadline_hits_and_misses_are_counted():
    """Every deadline is the tightest one admission accepts
    (``min_steps_to_finish`` prices exclusive service).  Three requests
    arriving together share the engine's one prefill chunk per step and
    miss; a fourth arriving after them is served alone and hits.  None is
    rejected."""
    _, tc, *_ = _served()
    reqs = [Request(rid=r.rid, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens, arrival_step=arrival,
                    deadline_steps=sla.min_steps_to_finish(
                        r, ECFG["chunk"]) - 1)
            for r, arrival in zip(_trace(tc.vocab_size, n=4, seed=0),
                                  (0, 0, 0, 100))]
    rep = _engine(sla=sla.SlaConfig()).run(reqs)
    hits = [r["deadline_hit"] for r in rep.requests]
    assert hits == [r["finished_step"] - r["arrival_step"] <= q.deadline_steps
                    for r, q in zip(rep.requests, reqs)]
    assert hits == [False, False, False, True]
    assert rep.deadline_hits == 1 and rep.deadline_misses == 3
    assert rep.rejected == 0


def test_over_budget_stream_is_a_prefix_neighbours_equal():
    trace, _, trep = _sla_runs()
    free = _engine(sla=sla.SlaConfig(aging_steps=4)).run(
        [Request(**{**r, "joule_budget": None}) for r in trace])
    got = {r["rid"]: r for r in trep.requests}
    want = {r["rid"]: r for r in free.requests}
    rec = got[901]
    assert 1 <= len(rec["tokens"]) < len(want[901]["tokens"])
    assert rec["tokens"] == want[901]["tokens"][:len(rec["tokens"])]
    assert rec["joules_used"] > trace[-1]["joule_budget"]
    for rid, r in got.items():
        if rid != 901:
            assert r["tokens"] == want[rid]["tokens"], rid


def test_sla_run_killed_and_resumed_equals_unbroken(tmp_path):
    from repro_torch.checkpoint import checkpoint
    trace, _, trep = _sla_runs()
    reqs = [Request(**r) for r in trace]
    for k in (2, trep.steps // 2, trep.steps - 2):
        victim = _engine(sla=sla.SlaConfig(aging_steps=4))
        rep = victim.run(reqs, FaultConfig(
            injector=fi.FaultInjector([fi.PreemptAt(k)]),
            snapshot_dir=str(tmp_path), snapshot_keep=1))
        assert rep.preempted
        flat, _ = checkpoint.load_engine_snapshot(tmp_path, step=k)
        survivor = _engine(sla=sla.SlaConfig(aging_steps=4))
        survivor.restore(flat)
        resumed = survivor.resume()
        _same_streams(trep, resumed)
        assert (resumed.rejected, resumed.over_budget) == (1, 1)
        assert resumed.analog_energy_j == trep.analog_energy_j
