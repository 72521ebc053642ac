"""The port's streaming telemetry against the JAX package's: rolling
median / MAD, alert rules, emitters and sink snapshots equal module against
module on the same seeded samples; a sink-wired port engine streams every
series but the host-clock ones (``step_latency_s``, ``straggler_dt_s``,
``heartbeat``) value for value and step for step as the JAX engine's sink;
and the port's engine on its own (tests/test_telemetry.py's engine tests):
streams unchanged with a sink, one spike for a warm straggler, JSONL
flushed on ``report()`` and on preemption."""
import functools
import json

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
from repro.runtime import fault as jfault
from repro.runtime import telemetry as jtele
from repro_torch import convert
from repro_torch.configs import TDVMMPlan as TPlan
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke as tsmoke
from repro_torch.configs import tdvmm_rule as trule
from repro_torch.core.calibration import CalibrationState
from repro_torch.runtime import fault
from repro_torch.runtime import faultinject as fi
from repro_torch.runtime import telemetry as tele
from repro_torch.runtime.engine import (DriftConfig, Engine, EngineConfig,
                                        FaultConfig, Request)


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


# the JAX package's telemetry tests' engine shape (tests/test_telemetry.py)
ECFG = dict(slots=3, page_size=4, num_pages=32, chunk=4)
# series read off the host clock: they differ between any two runs
CLOCK_SERIES = {"step_latency_s", "straggler_dt_s", "heartbeat"}


def _samples(seed: int, n: int = 200) -> np.ndarray:
    """Heavy-tailed samples with repeats (ties in the sorted window)."""
    rng = np.random.default_rng(seed)
    xs = rng.lognormal(0.0, 1.5, size=n)
    xs[rng.integers(0, n, n // 5)] = 1.0
    return xs


# --------------------------------------------------------------------------
# Module against module
# --------------------------------------------------------------------------
@pytest.mark.parametrize("capacity, window", [(64, 9), (16, 32), (512, 1),
                                              (8, 8)])
def test_rolling_series_equals_reference(capacity, window):
    xs = _samples(capacity + window)
    a = tele.RollingSeries(capacity=capacity, window=window)
    b = jtele.RollingSeries(capacity=capacity, window=window)
    assert (a.median(), a.mad(), a.last) == (b.median(), b.mad(), b.last)
    for i, x in enumerate(xs):
        a.push(i, x)
        b.push(i, x)
        assert (a.median(), a.mad(), a.last) == (b.median(), b.mad(), b.last)
    assert list(a.values) == list(b.values) and list(a.steps) == list(b.steps)
    assert a.count == b.count == len(xs)
    assert a.state_dict() == b.state_dict()


def test_rolling_series_state_dict_round_trips_across_packages():
    """The JAX sink's series state, through JSON, continues in the port's
    series with the same statistics (the sorted window is rebuilt
    exactly), and back."""
    xs = _samples(5)
    ref = jtele.RollingSeries(capacity=16, window=7)
    for i, x in enumerate(xs[:40]):
        ref.push(i, x)
    mine = tele.RollingSeries(capacity=16, window=7)
    mine.load_state_dict(json.loads(json.dumps(ref.state_dict())))
    assert mine._sorted == ref._sorted
    for i, x in enumerate(xs[40:], start=40):
        ref.push(i, x)
        mine.push(i, x)
        assert (mine.median(), mine.mad()) == (ref.median(), ref.mad())
    back = jtele.RollingSeries(capacity=16, window=7)
    back.load_state_dict(json.loads(json.dumps(mine.state_dict())))
    assert back.state_dict() == ref.state_dict()
    with pytest.raises(ValueError, match=">= 1"):
        tele.RollingSeries(window=0)


def _rules(mod):
    R = mod.AlertRule
    return [R("m", kind="spike", k=3.0, min_samples=4),
            R("m", kind="spike", k=6.0, min_samples=2, abs_floor=0.5),
            R("m", kind="spike", k=6.0, min_samples=2, rel_floor=0.5),
            R("m", kind="threshold", limit=3.0),
            R("m", kind="regression", baseline=2.0, tol=0.1),
            R("other", kind="threshold", limit=0.0)]


@pytest.mark.parametrize("kind", ["spike", "threshold", "regression"])
def test_alert_rules_fire_as_reference(kind):
    """Each kind, with and without its deadbands, on a series that crosses
    every bound: the same alerts, at the same steps, with the same limits,
    medians and MADs."""
    xs = _samples(11, 120)
    mine = tele.MetricsSink(rules=[r for r in _rules(tele) if r.kind == kind],
                            window=8, capacity=32)
    ref = jtele.MetricsSink(rules=[r for r in _rules(jtele) if r.kind == kind],
                            window=8, capacity=32)
    for step, x in enumerate(xs):
        got = mine.observe("m", x, step)
        want = ref.observe("m", x, step)
        assert [a.to_json() for a in got] == [a.to_json() for a in want]
    assert len(mine.alerts) > 0
    assert mine.summary() == ref.summary()
    # a rule evaluated directly: the deadbands and min_samples
    for rule, jrule_ in zip(_rules(tele), _rules(jtele)):
        for args in ((10.0, 1.0, 0.1, 1, 0), (1.2, 1.0, 0.0, 8, 1),
                     (1.6, 1.0, 0.0, 8, 2), (2.1, 2.0, 0.01, 9, 3)):
            a, b = rule.evaluate(*args), jrule_.evaluate(*args)
            assert (a and a.to_json()) == (b and b.to_json())


@pytest.mark.parametrize("bad, match", [
    (dict(kind="mean"), "unknown alert kind"),
    (dict(kind="threshold"), "needs limit="),
    (dict(kind="regression"), "needs baseline=")])
def test_alert_rule_validation_as_reference(bad, match):
    with pytest.raises(ValueError, match=match):
        tele.AlertRule("m", **bad)
    with pytest.raises(ValueError, match=match):
        jtele.AlertRule("m", **bad)


def test_emitters_write_what_the_reference_writes(tmp_path, capsys):
    rules = lambda mod: [mod.AlertRule("m", kind="threshold", limit=1.0)]
    mem, jmem = tele.MemoryEmitter(), jtele.MemoryEmitter()
    mine = tele.MetricsSink(rules=rules(tele), emitters=[
        mem, tele.JsonlEmitter(tmp_path / "a.jsonl"), tele.StdoutEmitter()])
    ref = jtele.MetricsSink(rules=rules(jtele), emitters=[
        jmem, jtele.JsonlEmitter(tmp_path / "b.jsonl"),
        jtele.StdoutEmitter()])
    for step, x in enumerate((0.5, 2.0, 0.25, 3.0)):
        mine.observe("m", x, step)
        mine.observe("n", step, step)
    port_out = capsys.readouterr().out
    for step, x in enumerate((0.5, 2.0, 0.25, 3.0)):
        ref.observe("m", x, step)
        ref.observe("n", step, step)
    assert port_out == capsys.readouterr().out and port_out.count("ALERT") == 2
    mine.flush(), ref.flush()
    assert mem.metrics == jmem.metrics
    assert [a.to_json() for a in mem.alerts] == \
        [a.to_json() for a in jmem.alerts]
    assert (tmp_path / "a.jsonl").read_text() == \
        (tmp_path / "b.jsonl").read_text()
    for em in mine.emitters + ref.emitters:
        em.close()
    # reopening appends (a resumed serve run keeps one growing file)
    tele.JsonlEmitter(tmp_path / "a.jsonl").on_metric("m", 9, 1.0)
    assert len((tmp_path / "a.jsonl").read_text().splitlines()) == 11


def _fed(mod):
    sink = mod.MetricsSink(rules=[mod.AlertRule(
        "m", kind="spike", k=3.0, min_samples=4, abs_floor=0.01)],
        window=8, capacity=32)
    xs = _samples(7, 50)
    for step, x in enumerate(xs):
        sink.observe("m", x, step)
        sink.observe("aux", float(step), step)
    return sink


def test_sink_snapshot_equals_reference_and_restores_across():
    mine, ref = _fed(tele), _fed(jtele)
    assert mine.snapshot() == ref.snapshot()
    assert json.loads(json.dumps(mine.snapshot())) == mine.snapshot()
    # the JAX sink's snapshot, restored into a port sink, continues it
    other = tele.MetricsSink(rules=mine.rules, window=8, capacity=32)
    other.restore(json.loads(json.dumps(ref.snapshot())))
    assert other.summary() == ref.summary()
    for step in range(50, 60):
        a = other.observe("m", float(step % 3) * 0.7, step)
        b = ref.observe("m", float(step % 3) * 0.7, step)
        assert [x.to_json() for x in a] == [x.to_json() for x in b]
    assert other.snapshot() == ref.snapshot()
    with pytest.raises(ValueError, match="not a MetricsSink snapshot"):
        tele.MetricsSink().restore({"nope": 1})


# --------------------------------------------------------------------------
# Engine against engine
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _served():
    """(jax cfg, port cfg, jax params, port params, jax calib, port calib,
    calibration tokens) of the smoke qwen under ``ffn.*``."""
    jc = jsmoke(jget("qwen1.5-0.5b")).replace(tdvmm_plan=JPlan(
        (jrule("ffn.*", enabled=True, backend="jnp"),)))
    tc = tsmoke(tget("qwen1.5-0.5b")).replace(tdvmm_plan=TPlan(
        (trule("ffn.*", enabled=True),)))
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jc)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), tc,
                                        "cpu")
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0,
                                         jc.vocab_size))
    jcal = jmodel.calibrate(jparams, {"inputs": tokens}, jc, max_len=48)
    tcal = CalibrationState(windows={
        s: torch.from_numpy(np.array(v, np.float32))
        for s, v in jcal.windows.items()})
    return jc, tc, jparams, tparams, jcal, tcal, tokens


def _trace(vocab, n=4, seed=0):
    rng = np.random.default_rng(seed)
    reqs, arrival = [], 0
    for rid in range(n):
        reqs.append(dict(
            rid=rid,
            prompt=tuple(int(t) for t in rng.integers(
                0, vocab, rng.integers(3, 11))),
            max_new_tokens=int(rng.integers(2, 6)),
            arrival_step=arrival))
        arrival += int(rng.integers(0, 2))
    return reqs


def _engine(sink=None):
    _, tc, _, tparams, _, tcal, _ = _served()
    return Engine(tc, tparams, EngineConfig(**ECFG), calib=tcal, sink=sink,
                  device="cpu")


@functools.lru_cache(maxsize=None)
def _sink_runs():
    """The trace through both engines, each with a MemoryEmitter sink, a
    straggler monitor, a heartbeat and drift probes (clip series every 2
    steps, a full check every 4): (trace, JAX report, JAX emitter, port
    report, port emitter, port sink)."""
    import tempfile
    jc, tc, jparams, tparams, jcal, tcal, tokens = _served()
    trace = _trace(jc.vocab_size)
    jem, tem = jtele.MemoryEmitter(), tele.MemoryEmitter()
    jsink = jtele.MetricsSink(emitters=[jem])
    tsink = tele.MetricsSink(emitters=[tem])
    with tempfile.TemporaryDirectory() as tmp:
        jrep = jengine.Engine(
            jc, jparams, jengine.EngineConfig(**ECFG), calib=jcal,
            sink=jsink).run([jengine.Request(**r) for r in trace],
                            jengine.FaultConfig(
            monitor=jfault.StragglerMonitor(sink=jsink),
            heartbeat=jfault.Heartbeat(f"{tmp}/j.json", every_s=0.0,
                                       sink=jsink),
            drift=jengine.DriftConfig(
                probe_batch={"inputs": jax.numpy.asarray(tokens)},
                check_every=4, observe_every=2)))
        trep = _engine(tsink).run([Request(**r) for r in trace], FaultConfig(
            monitor=fault.StragglerMonitor(sink=tsink),
            heartbeat=fault.Heartbeat(f"{tmp}/t.json", every_s=0.0,
                                      sink=tsink),
            drift=DriftConfig(probe_batch={"inputs": torch.from_numpy(tokens)},
                              check_every=4, observe_every=2)))
    return trace, jrep, jem, trep, tem, tsink


def test_sink_series_equal_reference_engine():
    """Every series but the host-clock ones, value for value and step for
    step, in the order the JAX engine's sink saw them."""
    _, jrep, jem, trep, tem, tsink = _sink_runs()
    want = [m for m in jem.metrics if m[0] not in CLOCK_SERIES]
    got = [m for m in tem.metrics if m[0] not in CLOCK_SERIES]
    assert got == want
    names = {m[0] for m in got}
    assert {"queue_depth", "active_slots", "page_in_use", "page_high_water",
            "generated_tokens", "step_retries", "fj_per_op",
            "drift_max_clip_rate", "drift_max_log_ratio",
            "clip_rate.ffn.in", "clip_rate.ffn.out"} <= names
    # the host-clock series exist with the same sample counts
    for name in ("step_latency_s", "heartbeat"):
        assert [m[1] for m in tem.metrics if m[0] == name] == \
            [m[1] for m in jem.metrics if m[0] == name]
    assert trep.alerts == jrep.alerts == 0
    assert trep.telemetry == tsink.summary()
    assert trep.telemetry["observations"] == len(tem.metrics)
    # the running fJ/Op ends on the report's figure
    assert tsink.series["fj_per_op"].last == pytest.approx(trep.fj_per_op)


def test_sink_wired_streams_equal_reference_and_unwired():
    trace, jrep, _, trep, _, _ = _sink_runs()
    plain = _engine().run([Request(**r) for r in trace])
    for a, b, c in zip(jrep.requests, trep.requests, plain.requests):
        assert a["tokens"] == b["tokens"] == c["tokens"], (a, b)
        assert a["finish_reason"] == b["finish_reason"] == c["finish_reason"]
        assert a["finished_step"] == b["finished_step"] == c["finished_step"]
    assert trep.steps == jrep.steps == plain.steps
    assert trep.step_shapes == 2 and plain.telemetry is None
    assert trep.recalibrations == 0


# --------------------------------------------------------------------------
# The port's engine on its own (tests/test_telemetry.py's engine tests)
# --------------------------------------------------------------------------
@pytest.fixture
def _one_thread():
    """Step latencies on one intra-op thread: on a host loaded by other
    test workers, every op of a multi-threaded pool waits for its slowest,
    descheduled thread, which stretches the smoke engine's millisecond steps
    to tenths of a second with a MAD to match (a spike can then hide in it,
    or a stall fire one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_warm_engine_slowstep_fires_exactly_one_spike(_one_thread):
    _, tc, *_ = _served()
    reqs = [Request(**r) for r in _trace(tc.vocab_size)]
    rule = tele.AlertRule("step_latency_s", kind="spike", k=6.0,
                          min_samples=6, abs_floor=0.05)
    sink = tele.MetricsSink(rules=[rule])
    eng = _engine(sink)
    ref = eng.run(reqs)                          # warm-up
    warm = len(sink.alerts)
    eng.run(reqs)                                # clean warm run: no alert
    assert len(sink.alerts) == warm
    slow = max(1, ref.steps // 2)
    # the injected sleep stands well above the host's own jitter, which a
    # loaded host can still widen until 0.3 s sits inside the rule's
    # median + k * MAD
    lat = sink.series["step_latency_s"]
    sleep_s = max(0.3, 4.0 * max(rule.k * lat.mad(), rule.abs_floor))
    rep = eng.run(reqs, FaultConfig(
        injector=fi.FaultInjector([fi.SlowStep(slow, sleep_s=sleep_s)])))
    injected = sink.alerts[warm:]
    assert len(injected) == 1, injected
    assert injected[0].metric == "step_latency_s"
    # the sleep is inside the step; the tick's dt is observed after the
    # step counter moved past it
    assert injected[0].step == slow + 1 and injected[0].value >= sleep_s
    for ra, rb in zip(ref.requests, rep.requests):
        assert ra["tokens"] == rb["tokens"]
    assert rep.step_shapes == 2


def _jsonl_metrics(path):
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    return [ln for ln in lines if ln["t"] == "metric"]


def test_jsonl_flushed_on_report_without_close(tmp_path):
    _, tc, *_ = _served()
    path = tmp_path / "metrics.jsonl"
    sink = tele.MetricsSink(emitters=[tele.JsonlEmitter(path)])
    _engine(sink).run([Request(**r) for r in _trace(tc.vocab_size)])
    assert len(_jsonl_metrics(path)) == sink.observations > 0


def test_jsonl_flushed_on_preemption_exit(tmp_path):
    _, tc, *_ = _served()
    path = tmp_path / "metrics.jsonl"
    sink = tele.MetricsSink(emitters=[tele.JsonlEmitter(path)])
    rep = _engine(sink).run(
        [Request(**r) for r in _trace(tc.vocab_size)],
        FaultConfig(injector=fi.FaultInjector([fi.PreemptAt(3)]),
                    snapshot_dir=str(tmp_path / "snap")))
    assert rep.preempted and rep.snapshot_path is not None
    assert len(_jsonl_metrics(path)) == sink.observations > 0


def test_sink_rides_snapshot_and_continues_its_series():
    """Killed at every other step and restored into a fresh engine with a
    fresh sink: every series' samples equal the unbroken run's, but
    step_latency_s's values (host clock)."""
    _, tc, *_ = _served()
    reqs = [Request(**r) for r in _trace(tc.vocab_size)]
    base = tele.MetricsSink()
    whole = _engine(base).run(reqs)
    for k in range(1, whole.steps, 2):
        victim = _engine(tele.MetricsSink())
        victim.run(reqs, FaultConfig(
            injector=fi.FaultInjector([fi.PreemptAt(k)])))
        snap = json.loads(json.dumps(victim.sink.snapshot()))
        sink = tele.MetricsSink()
        survivor = _engine(sink)
        survivor.restore(victim.snapshot())
        assert sink.snapshot() == snap
        rep = survivor.resume()
        assert [r["tokens"] for r in rep.requests] == \
            [r["tokens"] for r in whole.requests]
        assert sink.observations == base.observations, k
        assert sink.series.keys() == base.series.keys()
        for name, s in sink.series.items():
            assert list(s.steps) == list(base.series[name].steps), name
            if name not in CLOCK_SERIES:
                assert list(s.values) == list(base.series[name].values), name
