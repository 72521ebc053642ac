"""The MoE family in the port's paged engine (the smoke kimi-k2: 4 experts,
top-2, one shared expert, float32) against the JAX package's engine with
``backend="jnp"``: streams, finish steps, steps, pages and energy under
``moe.*`` unchained and chained, at 3 slots and at 6 (where a decode step
can drop past the expert capacity); batched == solo where no decode step
can drop; kill and resume, in-place drift recalibration of the (E,)
windows, a sink-wired and traced run, the serve CLI; and the expert bank
programmed a slice of experts at a time, bitwise the whole bank."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TDVMMPlan as JPlan
from repro.configs import get_config as jget
from repro.configs import smoke as jsmoke
from repro.configs import tdvmm_rule as jrule
from repro.models import model as jmodel
from repro.runtime import engine as jengine
from repro.runtime import trace as jtrace
from repro_torch import convert
from repro_torch.checkpoint import checkpoint
from repro_torch.configs import TDVMMPlan as TPlan
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke as tsmoke
from repro_torch.configs import tdvmm_rule as trule
from repro_torch.core import layers as tlayers
from repro_torch.core import quant
from repro_torch.core.layers import TDVMMLayerConfig as TLayer
from repro_torch.launch import serve
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.runtime import faultinject as fi
from repro_torch.runtime import telemetry as tele
from repro_torch.runtime import trace
from repro_torch.runtime.engine import (DriftConfig, Engine, EngineConfig,
                                        FaultConfig, Request)

ARCH = "kimi-k2-1t-a32b"
CHAINED = ("moe.expert.in", "moe.shared.in")


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


@functools.lru_cache(maxsize=None)
def _served(chain: bool):
    """(jax cfg, port cfg, jax params, port params, jax calib, port calib,
    calibration tokens) of the smoke kimi-k2 under ``moe.*``; the port's
    windows, from its own calibration pass, bitwise the JAX package's."""
    jr = [jrule("moe.*", enabled=True, backend="jnp")]
    tr = [trule("moe.*", enabled=True)]
    if chain:
        jr += [jrule(s, chain=True) for s in CHAINED]
        tr += [trule(s, chain=True) for s in CHAINED]
    jc = jsmoke(jget(ARCH)).replace(tdvmm_plan=JPlan(tuple(jr)))
    tc = tsmoke(tget(ARCH)).replace(tdvmm_plan=TPlan(tuple(tr)))
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jc)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), tc,
                                        "cpu")
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0,
                                         jc.vocab_size))
    jcal = jmodel.calibrate(jparams, {"inputs": jnp.asarray(tokens)}, jc,
                            max_len=48)
    tcal = tmodel.calibrate(tparams, {"inputs": torch.from_numpy(tokens)}, tc,
                            max_len=48, device="cpu")
    assert set(tcal.windows) == set(jcal.windows)
    for site in jcal.windows:
        np.testing.assert_array_equal(tcal.windows[site].numpy(),
                                      np.asarray(jcal.windows[site]))
    return jc, tc, jparams, tparams, jcal, tcal, tokens


def _trace(vocab, n=4, seed=0, prompt=(3, 11), gen=(2, 6), max_gap=1):
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


def _ecfg(slots=3, chunk=4, **kw):
    return dict(slots=slots, page_size=4, num_pages=48, chunk=chunk, **kw)


def _engine(chain=False, calib=None, ecfg=None, **kw):
    _, tc, _, tparams, _, tcal, _ = _served(chain)
    return Engine(tc, tparams, EngineConfig(**(ecfg or _ecfg())),
                  calib=tcal if calib is None else calib, device="cpu", **kw)


def _same_streams(a, b):
    for ra, rb in zip(a.requests, b.requests):
        assert ra["tokens"] == rb["tokens"], (ra, rb)
        assert ra["finish_reason"] == rb["finish_reason"], (ra, rb)
        assert ra["finished_step"] == rb["finished_step"], (ra, rb)
    assert a.steps == b.steps


def test_paged_caches_for_the_moe_family():
    _, tc, *_ = _served(False)
    pools = tmodel.init_paged_caches(tc, 8, 4, "cpu")
    assert list(pools) == ["seg0"]
    assert tuple(pools["seg0"].k.shape) == (2, 9, 4, tc.n_kv_heads,
                                            tc.head_dim)


# --------------------------------------------------------------------------
# Against the JAX package's engine
# --------------------------------------------------------------------------
@pytest.mark.parametrize("slots", [3, 6])
@pytest.mark.parametrize("chain", [False, True])
def test_moe_engine_matches_reference_engine(chain, slots, monkeypatch):
    """At 6 slots a decode step holds more rows than an expert's capacity
    of 4 (E 4, top-2, factor 1.25), and some do drop: the port still gives
    the JAX engine's streams."""
    jc, tc, jparams, tparams, jcal, tcal, _ = _served(chain)
    scatter, decode_drops = tmoe._scatter_to_buffer, []

    def counting(x_flat, se, pos, tok, n_experts, capacity):
        if x_flat.shape[0] == slots:                 # a decode step's rows
            decode_drops.append(int((pos >= capacity).sum()))
        return scatter(x_flat, se, pos, tok, n_experts, capacity)
    monkeypatch.setattr(tmoe, "_scatter_to_buffer", counting)
    trace_ = _trace(jc.vocab_size, n=8, seed=slots, gen=(4, 9), max_gap=0)
    ecfg = _ecfg(slots=slots, chunk=8)
    jrep = jengine.Engine(jc, jparams, jengine.EngineConfig(**ecfg),
                          calib=jcal).run([jengine.Request(**r)
                                           for r in trace_])
    trep = Engine(tc, tparams, EngineConfig(**ecfg), calib=tcal,
                  device="cpu").run([Request(**r) for r in trace_])
    assert trep.step_shapes == 2 and trep.nan_logit_steps == 0
    _same_streams(trep, jrep)
    for key in ("steps", "prefill_steps", "decode_steps", "generated_tokens",
                "page_high_water", "analog_ops", "analog_energy_j",
                "fj_per_op"):
        assert getattr(trep, key) == getattr(jrep, key), key
    assert all(r["finish_reason"] == "max_tokens" for r in trep.requests)
    assert len(decode_drops) == tc.n_layers * trep.decode_steps > 0
    assert (sum(decode_drops) > 0) == (slots == 6)


@pytest.mark.parametrize("slot_order", ["fifo", "lifo"])
def test_moe_batched_equals_solo_with_chunked_prefill(slot_order):
    """3 slots: a decode step puts at most 3 rows on an expert, under its
    capacity of 4, and a prefill chunk's drops depend on that chunk only."""
    _, tc, *_ = _served(False)
    reqs = [Request(**r) for r in _trace(tc.vocab_size, n=5, seed=3,
                                         prompt=(6, 14))]
    ecfg = _ecfg(slot_order=slot_order)
    rep = _engine(ecfg=ecfg).run(reqs)
    assert rep.step_shapes == 2
    for req, rec in zip(reqs, rep.requests):
        solo = _engine(ecfg=ecfg).run(
            [Request(req.rid, req.prompt, req.max_new_tokens, 0)])
        assert rec["tokens"] == solo.requests[0]["tokens"]


# --------------------------------------------------------------------------
# Fault tolerance, drift, telemetry and tracing on a MoE engine
# --------------------------------------------------------------------------
def _first_decode_step(reqs) -> int:
    eng = _engine()
    eng.start(reqs)
    st = eng._st
    while True:
        k, d0 = st.steps, st.decode_steps
        assert eng.tick()
        if st.decode_steps > d0:
            return k


def test_moe_kill_at_first_decode_resumes_to_the_unbroken_streams(tmp_path):
    _, tc, *_ = _served(False)
    reqs = [Request(**r) for r in _trace(tc.vocab_size)]
    base = _engine().run(reqs)
    k = _first_decode_step(reqs)
    assert 0 < k < base.steps
    rep = _engine().run(reqs, FaultConfig(
        injector=fi.FaultInjector([fi.PreemptAt(k)]),
        snapshot_dir=str(tmp_path), snapshot_keep=1))
    assert rep.preempted and rep.steps == k
    flat, step = checkpoint.load_engine_snapshot(tmp_path)
    assert step == k
    survivor = _engine()
    survivor.restore(flat)
    resumed = survivor.resume()
    assert not resumed.preempted and resumed.step_shapes <= 2
    _same_streams(resumed, base)


def test_moe_drift_recalibrates_the_expert_windows_in_place():
    _, tc, _, _, _, tcal, tokens = _served(False)
    reqs = [Request(**r) for r in _trace(tc.vocab_size, n=6, seed=5)]
    eng = _engine()
    assert tuple(eng._windows["moe.expert.in"].shape) == (4,)
    ptrs = {s: t.data_ptr() for s, t in eng._windows.items()}
    rep = eng.run(reqs, FaultConfig(
        injector=fi.FaultInjector([fi.DriftAt(step=4, sigma=0.5,
                                              repeats=3)]),
        drift=DriftConfig(probe_batch={"inputs": torch.from_numpy(tokens)},
                          check_every=4, clip_threshold=0.005,
                          window_tol=0.05)))
    assert rep.recalibrations >= 1, rep.drift_events
    assert rep.step_shapes == 2
    assert {s: t.data_ptr() for s, t in eng._windows.items()} == ptrs
    moved = eng.pinned_calibration().drift_ratios(tcal)
    assert any(abs(np.log(max(r, 1e-12))) > 1e-6 for r in moved.values())
    assert tuple(eng._windows["moe.expert.out"].shape) == (4,)


def test_moe_sink_and_tracer_keep_the_untraced_streams():
    jc, tc, jparams, _, jcal, _, tokens = _served(False)
    trace_ = _trace(tc.vocab_size)
    reqs = [Request(**r) for r in trace_]
    plain = _engine().run(reqs)
    sink = tele.MetricsSink(rules=[tele.AlertRule(
        "clip_rate.moe.expert.in", kind="threshold", limit=1e-3)])
    tr = trace.Tracer()
    rep = _engine(sink=sink, tracer=tr).run(reqs, FaultConfig(
        drift=DriftConfig(probe_batch={"inputs": torch.from_numpy(tokens)},
                          check_every=10**9, observe_every=2)))
    _same_streams(rep, plain)
    assert rep.step_shapes == 2 and rep.recalibrations == 0
    clip = {n for n in sink.series if n.startswith("clip_rate.")}
    assert clip == {f"clip_rate.{s}" for s in _served(False)[5].windows}
    jtr = jtrace.Tracer()
    jengine.Engine(jc, jparams, jengine.EngineConfig(**_ecfg()), calib=jcal,
                   tracer=jtr).run([jengine.Request(**r) for r in trace_])

    def timeless(events):
        return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                for e in events]
    assert timeless(tr.chrome_trace()["traceEvents"]) == \
        timeless(jtr.chrome_trace()["traceEvents"])


def test_moe_cli_engine_run_equals_the_engine_api(capsys):
    rep = serve.main(["--arch", ARCH, "--smoke", "--tdvmm", "moe.*",
                      "--calibrate", "--device", "cpu"])
    assert "calibrated sites" in capsys.readouterr().out
    cfg = tsmoke(tget(ARCH)).replace(tdvmm_plan=TPlan(
        (trule("moe.*", enabled=True),)))
    params = tmodel.init_params(0, cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    calib = tmodel.calibrate(params, {"inputs": torch.randint(
        0, cfg.vocab_size, (4, 16), generator=gen)}, cfg, device="cpu")
    reqs = serve.make_trace(cfg.vocab_size, 8, 16, 16, 0)
    want = Engine(cfg, params, EngineConfig(
        slots=4, page_size=16, num_pages=64, chunk=16, max_pages_per_slot=2),
        calib=calib, device="cpu").run(reqs)
    _same_streams(rep, want)
    assert rep.step_shapes == 2 and rep.analog_energy_j == want.analog_energy_j


# --------------------------------------------------------------------------
# The expert bank programmed a slice of experts at a time
# --------------------------------------------------------------------------
@pytest.mark.parametrize("bits,per_channel,code_dtype", [
    (6, True, "int8"), (6, False, "int8"), (8, True, "f32"),
    (3, True, "int4")])
def test_bank_programmed_in_slices_is_bitwise_the_whole_bank(
        bits, per_channel, code_dtype, monkeypatch):
    """E 7 in slices of 3 experts (7 is not a multiple of 3): the codes,
    the scales and ``td_expert_matmul``'s output are bitwise the whole-bank
    programming's, in every code storage the plan can ask for."""
    e, c, k, n = 7, 5, 24, 40
    rng = np.random.default_rng(bits)
    w = torch.from_numpy(rng.standard_normal((e, k, n)).astype(np.float32))
    w[2] *= 0.0                               # an all-zero expert
    x = torch.from_numpy(rng.standard_normal((e, c, k)).astype(np.float32))
    whole = quant.program_weights(w, bits, per_channel)   # one slice
    cfg = TLayer(enabled=True, bits=bits, weight_bits=bits,
                 per_channel=per_channel)
    assert tlayers._plan_code_dtype(cfg, k, False) == code_dtype
    want = tlayers.td_expert_matmul(x, w, cfg)
    monkeypatch.setattr(quant, "SLICE_ELEMS", 3 * k * n)
    program = quant._program
    calls = []
    monkeypatch.setattr(quant, "_program", lambda w_, *a: calls.append(
        w_.shape[0]) or program(w_, *a))
    part = quant.program_weights(w, bits, per_channel)
    assert calls == [3, 3, 1]
    assert part.codes.dtype == whole.codes.dtype
    assert torch.equal(part.codes, whole.codes)
    assert part.scale.shape == whole.scale.shape
    assert torch.equal(part.scale, whole.scale)
    got = tlayers.td_expert_matmul(x, w, cfg)
    assert calls == [3, 3, 1] * 2
    assert torch.equal(got, want)
    # a bank that takes a gradient keeps the whole-tensor straight-through
    # term
    calls.clear()
    q = quant.program_weights(w.clone().requires_grad_(True), bits,
                              per_channel)
    assert calls == [e] and torch.equal(q.codes.detach(), whole.codes)


def test_bank_slices_at_kimis_width():
    """One slice is 1 GiB of float32: 18 of kimi-k2's 7168 x 2048 experts
    (384 in 22 slices, the last of 6)."""
    k, n = 7168, 2048
    assert quant.expert_step(torch.empty((384, k, n), device="meta")) == 18
    assert tmoe._capacity(4, 8, 384, 1.25) == 4
    assert tmoe._capacity(64, 8, 384, 1.25) == 4
    assert tmoe._capacity(2048, 8, 384, 1.25) == 54
