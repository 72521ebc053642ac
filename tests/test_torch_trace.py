"""The port's request tracing against the JAX package's: the schema check
accepts and rejects the same documents, the tracer records the same events
for the same hooks, a traced port engine records the JAX engine's events
(timestamps and durations aside), and ``launch/trace_report`` renders the
JAX tracer's document to the markdown of ``scripts/trace_report.py``; the
live ``clip_rate.<site>`` series equal the JAX package's
``clip_rate_metrics`` on its own drifted weights; and the port's engine on
its own (tests/test_trace.py's engine tests): traced == untraced, spans
carry the report's steps, one continuous trace across a kill and a disk
snapshot, bit-exact site attribution, the serve CLI's files; and the
profiler ranges of ``trace.span`` (a no-op with no profiler running; under
one, ``model.prefill`` / ``model.decode`` around each model step and
``engine.tick`` around each tick, one ``tdvmm.program`` inside a step for
each programmed bank, and outputs bitwise those of an unprofiled run)."""
import functools
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TDVMMPlan as JPlan
from repro.configs import get_config as jget
from repro.configs import smoke as jsmoke
from repro.configs import tdvmm_rule as jrule
from repro.core import calibration as jcalib
from repro.core.nonideal import NonIdealityConfig as JNonIdeal
from repro.models import model as jmodel
from repro.runtime import engine as jengine
from repro.runtime import faultinject as jfi
from repro.runtime import trace as jtrace
from repro_torch import convert
from repro_torch.checkpoint import checkpoint
from repro_torch.configs import TDVMMPlan as TPlan
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke as tsmoke
from repro_torch.configs import tdvmm_rule as trule
from repro_torch.core import calibration as tcalib
from repro_torch.core import quant as tquant
from repro_torch.core.nonideal import NonIdealityConfig
from repro_torch.launch import trace_report
from repro_torch.models import model as tmodel
from repro_torch.runtime import faultinject as fi
from repro_torch.runtime import telemetry as tele
from repro_torch.runtime import trace
from repro_torch.runtime.engine import (DriftConfig, Engine, EngineConfig,
                                        FaultConfig, Request)
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


# the JAX package's trace tests' engine shape (tests/test_trace.py)
ECFG = dict(slots=3, page_size=4, num_pages=32, chunk=4)


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
    jcal = jmodel.calibrate(jparams, {"inputs": jnp.asarray(tokens)}, jc,
                            max_len=48)
    tcal = tcalib.CalibrationState(windows={
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


def _engine(tracer=None, **kw):
    _, tc, _, tparams, _, tcal, _ = _served()
    kw.setdefault("calib", tcal)
    return Engine(tc, kw.pop("params", tparams), EngineConfig(**ECFG),
                  tracer=tracer, device="cpu", **kw)


def _same_streams(a, b):
    for ra, rb in zip(a.requests, b.requests):
        assert ra["tokens"] == rb["tokens"], (ra, rb)
        assert ra["finish_reason"] == rb["finish_reason"], (ra, rb)
        assert ra["finished_step"] == rb["finished_step"], (ra, rb)
    assert a.steps == b.steps


@functools.lru_cache(maxsize=None)
def _traced():
    """(requests, JAX tracer, untraced port report, traced port report,
    port tracer)."""
    jc, _, jparams, _, jcal, _, _ = _served()
    trace_ = _trace(jc.vocab_size)
    jtr = jtrace.Tracer()
    jengine.Engine(jc, jparams, jengine.EngineConfig(**ECFG), calib=jcal,
                   tracer=jtr).run([jengine.Request(**r) for r in trace_])
    reqs = [Request(**r) for r in trace_]
    plain = _engine().run(reqs)
    tr = trace.Tracer()
    rep = _engine(tr).run(reqs)
    return reqs, jtr, plain, rep, tr


def _timeless(events):
    """Events without their engine-clock stamps and durations."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in events]


# --------------------------------------------------------------------------
# Module against module
# --------------------------------------------------------------------------
_OK = {"ph": "X", "name": "t", "pid": 0, "tid": 0, "ts": 1.0, "dur": 2.0}
_B = {"ph": "B", "name": "s", "pid": 1, "tid": 7, "ts": 0}
DOCS = {
    "empty": {"traceEvents": []},
    "not a list": {"traceEvents": "x"},
    "unknown phase": [{**_OK, "ph": "Z"}],
    "string tid": [{**_OK, "tid": "r0"}],
    "bool pid": [{**_OK, "pid": True}],
    "ts None": [{**_OK, "ts": None}],
    "ts bool": [{**_OK, "ts": False}],
    "ts regresses": [_OK, {**_OK, "ts": 0.5}],
    "negative dur": [{**_OK, "dur": -1.0}],
    "no dur": [{k: v for k, v in _OK.items() if k != "dur"}],
    "E without B": [{**_B, "ph": "E"}],
    "E name mismatch": [_B, {**_B, "ph": "E", "name": "other", "ts": 1}],
    "unbalanced": [_B],
    "interleaved tids": [_B, {**_B, "tid": 8},
                         {**_B, "tid": 8, "ph": "E", "ts": 1},
                         {**_B, "ph": "E", "ts": 2}],
    "metadata without ts": [{"ph": "M", "name": "process_name", "pid": 0,
                             "tid": 0, "args": {"name": "engine"}}, _OK],
    "counters and instants": [
        {"ph": "C", "name": "q", "pid": 0, "tid": 0, "ts": 0,
         "args": {"q": 1.0}},
        {"ph": "i", "name": "finish:eos", "s": "t", "pid": 1, "tid": 3,
         "ts": 5}],
}


@pytest.mark.parametrize("name", list(DOCS))
def test_validator_agrees_with_reference(name):
    doc = DOCS[name]

    def verdict(fn):
        try:
            return ("ok", fn(doc))
        except ValueError as e:
            return ("raises", str(e))

    mine, ref = verdict(trace.validate_chrome_trace), \
        verdict(jtrace.validate_chrome_trace)
    assert mine == ref


def _drive(mod, max_events=200_000):
    """The same hook sequence on a tracer of ``mod``: arrivals, an
    admission, chunks, decodes, an idle jump, every finish kind, a
    reattach."""
    tr = mod.Tracer(max_events=max_events)
    tr.note_arrival(0, step=0)
    tr.note_arrival(1, step=0)
    tr.note_arrival(0, step=0)                  # idempotent
    tr.admitted(0, step=0, sid=2, dp_rank=0, pages=3)
    tr.mark_chunk(0, index=0, tokens=4, done=False, step=0)
    tr.tick_done(0, dt=0.0125, counters={"queue_depth": 1, "fj_per_op": 57.1})
    tr.mark_chunk(0, index=1, tokens=2, done=True, step=1)
    tr.tick_done(1, dt=0.5)
    tr.finished(1, step=2, reason="rejected")
    tr.mark_decode([0], step=2)
    tr.tick_done(2, dt=-1.0)                    # a negative dt clamps to 0
    tr.finished(0, step=3, reason="over_budget")
    tr.mark_idle(3, until=9)
    tr.tick_done(9, dt=1e-6)
    tr.admitted(5, step=9, sid=0, dp_rank=0, pages=1)   # arrival unseen
    tr.finished(5, step=10, reason="evicted")
    tr.finished(6, step=10, reason="failed")            # never seen at all
    tr.attach([Request(rid=0, prompt=(1,), max_new_tokens=1)])
    tr.note_arrival(0, step=11)                 # a new run, same tracer
    return tr


@pytest.mark.parametrize("max_events", [200_000, 12, 4])
def test_tracer_records_what_the_reference_records(max_events):
    mine, ref = _drive(trace, max_events), _drive(jtrace, max_events)
    assert mine.events == ref.events
    assert (mine.clock_us, mine.ticks, mine.dropped) == \
        (ref.clock_us, ref.ticks, ref.dropped)
    assert mine.chrome_trace() == ref.chrome_trace()
    assert mine.summary() == ref.summary()
    assert mine.snapshot() == ref.snapshot()
    trace.validate_chrome_trace(mine.chrome_trace())
    # the snapshot is plain JSON and continues the same open spans
    again = trace.Tracer()
    again.restore(json.loads(json.dumps(ref.snapshot())))
    again.finished(0, step=12, reason="eos")
    ref.finished(0, step=12, reason="eos")
    assert again.chrome_trace() == ref.chrome_trace()
    with pytest.raises(ValueError, match="not a Tracer snapshot"):
        trace.Tracer().restore({"bogus": 1})
    with pytest.raises(ValueError, match="max_events"):
        trace.Tracer(max_events=0)


def test_trace_report_renders_the_reference_markdown(tmp_path):
    """The JAX engine's trace through the port's renderer and through the
    JAX package's script: the same markdown, the same tables."""
    _, jtr, *_ = _traced()
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(jtr.chrome_trace()))
    spec = importlib.util.spec_from_file_location(
        "jax_trace_report", ROOT / "scripts" / "trace_report.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    events = trace_report.load_events(path)
    assert trace_report.request_waterfalls(events) == \
        script.request_waterfalls(events)
    assert trace_report.tick_breakdown(events) == script.tick_breakdown(events)
    assert trace_report.render_markdown(path) == script.render_markdown(path)
    out = tmp_path / "report.md"
    assert trace_report.main([str(path), "-o", str(out)]) == 0
    assert out.read_text() == script.render_markdown(path)


# --------------------------------------------------------------------------
# Engine against engine
# --------------------------------------------------------------------------
def test_traced_engine_records_the_reference_engines_events():
    _, jtr, _, _, tr = _traced()
    assert _timeless(tr.chrome_trace()["traceEvents"]) == \
        _timeless(jtr.chrome_trace()["traceEvents"])
    assert (tr.ticks, tr.dropped) == (jtr.ticks, jtr.dropped)
    us = ("queue_wait_us", "prefill_us", "decode_us", "total_us")
    mine, ref = tr.summary()["requests"], jtr.summary()["requests"]
    assert {r: {k: v for k, v in row.items() if k not in us}
            for r, row in mine.items()} == \
        {r: {k: v for k, v in row.items() if k not in us}
         for r, row in ref.items()}


def test_engine_report_autotune_has_the_reference_engines_keys():
    """The report's ``autotune`` (tests/test_trace.py asserts its keys of
    the JAX engine's): after a reset of both, the same requests plan the
    same "MxKxN:dtype" entries, int8 at the smoke qwen's ffn sites; none of
    these smoke shapes is in the port's table, so each is a miss."""
    from repro.kernels.tdvmm import ops as jops
    from repro_torch.kernels.tdvmm import ops as tops
    jc, _, jparams, _, jcal, _, _ = _served()
    trace_ = _trace(jc.vocab_size)
    jops.reset_autotune_report()
    jrep = jengine.Engine(jc, jparams, jengine.EngineConfig(**ECFG),
                          calib=jcal).run(
        [jengine.Request(**r) for r in trace_])
    tops.reset_autotune_report()
    rep = _engine().run([Request(**r) for r in trace_])
    mine, ref = rep.autotune, jrep.autotune
    assert set(mine) == set(ref) == {"platform", "entries", "misses"}
    assert set(mine["entries"]) == set(ref["entries"]) != set()
    assert all(k.endswith(":int8") for k in mine["entries"])
    assert mine["platform"] == "plain"
    assert mine["misses"] == sorted(mine["entries"])
    assert {v["platform"] for v in mine["entries"].values()} == {"plain"}


# --------------------------------------------------------------------------
# The port's engine on its own (tests/test_trace.py's engine tests)
# --------------------------------------------------------------------------
def test_traced_run_equals_untraced_with_two_step_shapes():
    _, _, plain, rep, _ = _traced()
    _same_streams(plain, rep)
    assert rep.step_shapes == 2
    assert plain.trace_summary is None and rep.trace_summary is not None


def test_trace_schema_valid_and_spans_carry_the_reports_steps():
    _, _, _, rep, tr = _traced()
    doc = tr.chrome_trace()
    counts = trace.validate_chrome_trace(doc)
    assert counts["B"] == counts["E"] > 0
    spans = {}
    for e in doc["traceEvents"]:
        if e.get("pid") == trace.REQUEST_PID and e["ph"] in "Bi":
            spans.setdefault(e["tid"], []).append((e["name"],
                                                   e["args"]["step"]))
    for r in rep.requests:
        want = [("queued", r["arrival_step"]),
                ("prefill", r["admitted_step"]),
                ("decode", r["first_token_step"]),
                (f"finish:{r['finish_reason']}", r["finished_step"])]
        assert spans[r["rid"]] == want, (r, spans[r["rid"]])
    slices = [e for e in doc["traceEvents"]
              if e.get("pid") == trace.ENGINE_PID and e["ph"] == "X"]
    assert rep.steps - 1 <= len(slices) <= rep.steps and tr.dropped == 0
    # the ticks' host wall time: each slice ends where its tick's counters
    # stand, and the clock is the sum over every tick (the last, draining
    # one has no slice), within the run's wall time
    ticks = sorted({e["ts"] for e in doc["traceEvents"] if e["ph"] == "C"})
    assert len(ticks) == tr.ticks and ticks[-1] == tr.clock_us
    assert all(e["ts"] + e["dur"] in ticks for e in slices)
    assert sum(e["dur"] for e in slices) <= tr.clock_us <= rep.wall_s * 1e6


def test_trace_summary_waterfall_is_consistent():
    _, _, _, rep, _ = _traced()
    summ = rep.trace_summary
    assert rep.steps <= summ["ticks"] <= rep.steps + 1
    assert set(summ["requests"]) == {str(r["rid"]) for r in rep.requests}
    for r in rep.requests:
        row = summ["requests"][str(r["rid"])]
        assert row["finished_step"] == r["finished_step"]
        assert row["admitted_step"] == r["admitted_step"]
        assert row["reason"] == r["finish_reason"] and row["chunks"] >= 1
        segs = [row["queue_wait_us"], row["prefill_us"], row["decode_us"]]
        assert all(s is not None and s >= 0 for s in segs), row
        assert row["total_us"] == pytest.approx(sum(segs))
    pct = summ["percentiles"]["total_us"]
    assert pct["n"] == len(rep.requests) and pct["p99"] >= pct["p50"]


def test_site_attribution_sums_bit_exactly_under_tracing():
    _, _, plain, rep, _ = _traced()
    for r in (plain, rep):
        attr = r.site_attribution
        assert attr["tokens"] == r.tokens_priced > 0
        ops = e_j = 0.0
        for row in attr["per_site"].values():
            ops += row["ops"]
            e_j += row["energy_j"]
        assert ops == r.analog_ops and e_j == r.analog_energy_j
        assert attr["fj_per_op"] == r.fj_per_op
    assert rep.site_attribution == plain.site_attribution


def test_report_to_json_serializes():
    _, _, _, rep, _ = _traced()
    doc = json.loads(json.dumps(rep.to_json()))
    assert doc["tokens_priced"] == rep.tokens_priced
    assert doc["site_attribution"]["per_site"] == \
        rep.site_attribution["per_site"]
    assert doc["trace_summary"]["ticks"] >= rep.steps
    assert (doc["rejected"], doc["over_budget"], doc["alerts"]) == (0, 0, 0)
    assert set(doc["autotune"]) == {"platform", "entries", "misses"}
    assert doc["autotune"] == rep.autotune


def test_trace_rides_a_disk_snapshot_as_one_document(tmp_path):
    reqs, _, plain, _, base_tr = _traced()
    base_doc = base_tr.chrome_trace()
    for k in (1, plain.steps // 2, plain.steps - 1):
        e1 = _engine(trace.Tracer())
        r1 = e1.run(reqs, FaultConfig(
            injector=fi.FaultInjector([fi.PreemptAt(k)]),
            snapshot_dir=str(tmp_path), snapshot_keep=1))
        assert r1.preempted
        trace.validate_chrome_trace(e1.tracer.chrome_trace())
        flat, _ = checkpoint.load_engine_snapshot(tmp_path, step=k)
        e2 = _engine(trace.Tracer())
        e2.restore(flat)
        _same_streams(plain, e2.resume())
        doc = e2.tracer.chrome_trace()
        trace.validate_chrome_trace(doc)
        # one document: the unbroken run's events, timestamps aside, and no
        # span auto-closed
        assert _timeless(doc["traceEvents"]) == \
            _timeless(base_doc["traceEvents"]), k
        assert e2.tracer.ticks == base_tr.ticks


def test_restore_trace_without_tracer_raises():
    reqs, *_ = _traced()
    e1 = _engine(trace.Tracer())
    e1.run(reqs, FaultConfig(injector=fi.FaultInjector([fi.PreemptAt(2)])))
    bare = _engine()
    with pytest.raises(ValueError, match="tracer"):
        bare.restore(e1.snapshot())
    assert bare._st is None


# --------------------------------------------------------------------------
# Live clip-rate series
# --------------------------------------------------------------------------
def _clip_rules(sites, limit):
    return [tele.AlertRule(f"clip_rate.{s}", kind="threshold", limit=limit)
            for s in sites]


def _clip_series(sink):
    return {name: list(zip(s.steps, s.values))
            for name, s in sink.series.items()
            if name.startswith("clip_rate.")}


def test_clip_series_equal_reference_on_its_drifted_weights():
    """The JAX package's drifted weights (its drift_params), carried across
    with convert and served against windows pinned at a quarter of the
    clean ones: every ``clip_rate.<site>`` observation equals the JAX
    package's clip_rate_metrics(drift_probe(...)) on those weights, and a
    threshold rule fires exactly on the observations above its limit."""
    jc, tc, jparams, _, jcal, _, tokens = _served()
    jd = jfi.drift_params(jparams, jax.random.PRNGKey(0), jfi._model_spec(jc),
                          JNonIdeal(dibl=False, weight_noise=True,
                                    sigma_tune=0.5), repeats=3)
    td = convert.params_from_numpy(jax.tree.map(np.asarray, jd), tc, "cpu")
    quarter = np.float32(0.25)
    jstale = jcalib.CalibrationState(windows={
        s: jnp.asarray(np.asarray(v) * quarter) for s, v in jcal.windows.items()})
    tstale = tcalib.CalibrationState(windows={
        s: torch.tensor(np.asarray(v) * quarter)
        for s, v in jcal.windows.items()})
    _, jclips = jmodel.drift_probe(jd, {"inputs": jnp.asarray(tokens)}, jc,
                                   jstale)
    want = jcalib.clip_rate_metrics(jclips)
    assert 0.0 < min(want.values()) and len(set(want.values())) == 2
    limit = sum(want.values()) / 2              # one site above, one below
    sink = tele.MetricsSink(rules=_clip_rules(jcal.windows, limit))
    rep = _engine(sink=sink, params=td, calib=tstale).run(
        [Request(**r) for r in _trace(tc.vocab_size)],
        FaultConfig(drift=DriftConfig(
            probe_batch={"inputs": torch.from_numpy(tokens)},
            check_every=10**9, observe_every=2)))
    series = _clip_series(sink)
    assert series.keys() == want.keys()
    for name, obs in series.items():
        assert [s for s, _ in obs] == list(range(2, rep.steps + 1, 2))
        assert all(v == want[name] for _, v in obs), (name, obs)
    fired = [(a.metric, a.step, a.value) for a in sink.alerts]
    assert fired == [(n, s, v) for s in range(2, rep.steps + 1, 2)
                     for n, obs in sorted(series.items())
                     for s2, v in obs if s2 == s and v > limit]
    assert len(fired) == rep.steps // 2
    assert rep.recalibrations == 0 and rep.drift_checks == []
    assert rep.step_shapes == 2


def test_clip_series_follow_an_injected_drift():
    """Windows pinned at 0.6 of the clean ones (so the clean weights clip
    too), drift injected at step 4: each observation up to it equals a
    direct drift_probe on the clean weights, each after it one on the
    drifted weights; no recalibration; alerts exactly above the limit."""
    _, tc, _, tparams, _, tcal, tokens = _served()
    pinned = tcalib.CalibrationState(windows={
        s: v * 0.6 for s, v in tcal.windows.items()})
    batch = {"inputs": torch.from_numpy(tokens)}
    ev = dict(sigma=0.5, seed=3, repeats=3)
    drifted = fi.drift_params(
        tparams, ev["seed"], fi._model_spec(tc),
        NonIdealityConfig(dibl=False, weight_noise=True, sigma_tune=ev["sigma"]),
        repeats=ev["repeats"])
    clean = tcalib.clip_rate_metrics(tmodel.drift_probe(
        tparams, batch, tc, pinned, device="cpu")[1])
    after = tcalib.clip_rate_metrics(tmodel.drift_probe(
        drifted, batch, tc, pinned, device="cpu")[1])
    assert clean != after
    limit = 0.5 * max(max(clean.values()), max(after.values()))
    sink = tele.MetricsSink(rules=_clip_rules(pinned.windows, limit))
    rep = _engine(sink=sink, calib=pinned).run(
        [Request(**r) for r in _trace(tc.vocab_size, n=6, seed=5)],
        FaultConfig(injector=fi.FaultInjector([fi.DriftAt(step=4, **ev)]),
                    drift=DriftConfig(probe_batch=batch, check_every=10**9,
                                      observe_every=2)))
    assert rep.idle_steps == 0 and rep.recalibrations == 0
    series = _clip_series(sink)
    assert series.keys() == clean.keys()
    for name, obs in series.items():
        for step, v in obs:
            assert v == (clean if step <= 4 else after)[name], (name, step)
    assert [(a.metric, a.step) for a in sink.alerts] == sorted(
        ((n, s) for n, obs in series.items() for s, v in obs if v > limit),
        key=lambda x: (x[1], x[0]))


# --------------------------------------------------------------------------
# The serve CLI
# --------------------------------------------------------------------------
def test_cli_writes_metrics_trace_and_report(tmp_path, capsys):
    from repro_torch.launch import serve
    files = {k: tmp_path / f for k, f in
             (("m", "metrics.jsonl"), ("t", "trace.json"),
              ("r", "report.json"))}
    rep = serve.main([
        "--arch", "qwen1.5-0.5b", "--smoke", "--tdvmm", "ffn.*",
        "--calibrate", "--device", "cpu", "--requests", "6", "--prompt-len",
        "12", "--gen", "6", "--chunk", "4", "--page-size", "4",
        "--num-pages", "32", "--sla", "--aging-steps", "4",
        "--metrics-jsonl", str(files["m"]), "--trace-out", str(files["t"]),
        "--report-json", str(files["r"]), "--clip-observe-every", "2",
        "--alert-on", "clip_rate.ffn.out:threshold:limit=0.5"])
    out = capsys.readouterr().out
    lines = [json.loads(ln) for ln in files["m"].read_text().splitlines()]
    assert sum(ln["t"] == "metric" for ln in lines) == \
        rep.telemetry["observations"]
    assert sum(ln["t"] == "alert" for ln in lines) == rep.alerts
    assert {"clip_rate.ffn.in", "clip_rate.ffn.out"} <= \
        {ln["metric"] for ln in lines if ln["t"] == "metric"}
    doc = json.loads(files["t"].read_text())
    trace.validate_chrome_trace(doc)
    report = json.loads(files["r"].read_text())
    assert report["steps"] == rep.steps and len(report["requests"]) == 6
    assert [r["priority"] for r in report["requests"]] == [0, 1, 2, 0, 1, 2]
    assert "[serve] sla: 0 rejected" in out and "[serve] trace:" in out
    md = trace_report.render_markdown(files["t"])
    for r in rep.requests:
        assert f"| {r['rid']} | {r['finish_reason']} " \
               f"| {r['finished_step']} |" in md
    with pytest.raises(SystemExit, match="--alert-on 'x': want"):
        serve.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
                    "--alert-on", "x"])


# --------------------------------------------------------------------------
# Profiler ranges inside the program (trace.span)
# --------------------------------------------------------------------------
RANGES = ("tdvmm.program", "model.prefill", "model.decode", "engine.tick")
# the smoke kimi-k2 (4 experts, top-2, one shared expert) under ``moe.*``
MOE_ECFG = dict(slots=2, page_size=4, num_pages=24, chunk=4)


@functools.lru_cache(maxsize=None)
def _moe():
    """(cfg, params, calibration, prompts (2, 6)) of the smoke kimi-k2."""
    cfg = tsmoke(tget("kimi-k2-1t-a32b")).replace(tdvmm_plan=TPlan(
        (trule("moe.*", enabled=True),)))
    params = tmodel.init_params(0, cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 6), generator=gen)
    calib = tmodel.calibrate(params, {"inputs": tokens}, cfg, max_len=16,
                             device="cpu")
    return cfg, params, calib, tokens


def _static_steps():
    """A prefill and two decode steps of the smoke kimi-k2: (logits of each
    step, the caches after the last)."""
    cfg, params, calib, tokens = _moe()
    caches = tmodel.init_caches(cfg, 2, 16, "cpu")
    logits, caches = tmodel.prefill_step(params, {"inputs": tokens}, caches,
                                         cfg, calib=calib)
    out = [logits]
    for _ in range(2):
        tok = torch.argmax(logits[:, -1:], -1)
        logits, caches = tmodel.decode_step(params, {"inputs": tok}, caches,
                                            cfg, calib=calib)
        out.append(logits)
    return out, caches


def _engine_run():
    """The smoke kimi-k2's paged engine over three requests: (report, the
    page pools after the run)."""
    cfg, params, calib, tokens = _moe()
    eng = Engine(cfg, params, EngineConfig(**MOE_ECFG), calib=calib,
                 device="cpu")
    reqs = [Request(rid=i, prompt=tuple(int(t) for t in tokens[i % 2]),
                    max_new_tokens=3, arrival_step=i) for i in range(3)]
    rep = eng.run(reqs)
    return rep, eng._st.caches


def _profiled(fn, monkeypatch):
    """(fn()'s result, the program's ranges as (name, start_ns, end_ns)
    sorted outermost first, program_weights calls) under a CPU profiler;
    every expert bank is programmed one expert a slice, so a range per
    slice would show."""
    calls = []
    real = tquant.program_weights

    def counting(w, *a, **k):
        calls.append(tuple(w.shape))
        return real(w, *a, **k)
    monkeypatch.setattr(tquant, "program_weights", counting)
    monkeypatch.setattr(tquant, "SLICE_ELEMS", 1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.is_user_annotation() and e.name() in RANGES),
                    key=lambda r: (r[1], -r[2]))
    return out, ranges, calls


def _parents(ranges):
    """Each range's innermost enclosing range's name (None at the top);
    raises where two ranges overlap without nesting."""
    out, stack = [], []
    for name, a, b in ranges:
        while stack and stack[-1][2] <= a:
            stack.pop()
        if stack:
            assert b <= stack[-1][2], f"{name} overlaps {stack[-1][0]}"
        out.append((name, stack[-1][0] if stack else None))
        stack.append((name, a, b))
    return out


def _programs_per_step(ranges):
    """The number of ``tdvmm.program`` ranges inside each model step."""
    return [sum(1 for n, a, _ in ranges
                if n == "tdvmm.program" and lo <= a < hi)
            for name, lo, hi in ranges if name.startswith("model.")]


def _tensors(tree):
    return [t for t in leaves(tree) if isinstance(t, torch.Tensor)]


def test_span_is_the_shared_noop_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = trace.span("model.decode"), trace.span("tdvmm.program")
    assert a is b and type(a).__name__ == "nullcontext"
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = trace.span("model.decode")
        assert isinstance(on, torch.profiler.record_function)
    assert trace.span("model.decode") is a


def test_static_steps_record_nested_ranges(monkeypatch):
    _moe()
    _, ranges, calls = _profiled(_static_steps, monkeypatch)
    parents = _parents(ranges)
    steps = [n for n, p in parents if p is None]
    assert steps == ["model.prefill", "model.decode", "model.decode"]
    assert all(p in ("model.prefill", "model.decode")
               for n, p in parents if n == "tdvmm.program")
    programs = [n for n, _ in parents if n == "tdvmm.program"]
    assert calls and len(programs) == len(calls)
    assert any(len(s) == 3 for s in calls)       # the expert banks, sliced
    per_step = _programs_per_step(ranges)        # the same banks each step
    assert len(per_step) == 3 and len(set(per_step)) == 1
    assert {n for n, _ in parents} == {"model.prefill", "model.decode",
                                       "tdvmm.program"}


def test_engine_ticks_record_nested_ranges(monkeypatch):
    _moe()
    rep, ranges, calls = _profiled(lambda: _engine_run()[0], monkeypatch)
    parents = _parents(ranges)
    ticks = [n for n, p in parents if p is None]
    assert ticks and set(ticks) == {"engine.tick"}
    steps = [n for n, p in parents if p == "engine.tick"]
    assert steps.count("model.prefill") == rep.prefill_steps > 0
    assert steps.count("model.decode") == rep.decode_steps > 0
    assert len(steps) <= len(ticks)
    programs = [p for n, p in parents if n == "tdvmm.program"]
    assert len(programs) == len(calls) > 0
    assert set(programs) == {"model.prefill", "model.decode"}
    per_step = _programs_per_step(ranges)
    assert len(per_step) == rep.prefill_steps + rep.decode_steps
    assert len(set(per_step)) == 1


@pytest.mark.parametrize("run", ["static", "engine"])
def test_outputs_bitwise_equal_with_the_profiler_on(run):
    fn = _static_steps if run == "static" else _engine_run
    _moe()
    plain = fn()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiled = fn()
    if run == "engine":
        _same_streams(plain[0], profiled[0])
    a, b = _tensors(plain), _tensors(profiled)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
