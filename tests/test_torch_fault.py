"""The port's fault tolerance and drift recalibration against the JAX
package's: an engine killed at every step and restored from disk resumes to
the JAX engine's streams; the drift probe's windows and clip rates equal the
JAX package's exactly at scalar, per-expert and grouped sites, on the JAX
package's own drifted weights; retries, failures, in-place recalibration,
snapshots, the checkpoints of windows and snapshots, and the serve CLI's
fault flags."""
import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TDVMMLayerConfig as JLayer
from repro.configs import TDVMMPlan as JPlan
from repro.configs import get_config as jget
from repro.configs import smoke as jsmoke
from repro.configs import tdvmm_rule as jrule
from repro.core import calibration as jcalib
from repro.core import layers as jlayers
from repro.core.nonideal import NonIdealityConfig as JNonIdeal
from repro.models import model as jmodel
from repro.runtime import engine as jengine
from repro.runtime import faultinject as jfi
from repro_torch import convert
from repro_torch.checkpoint import checkpoint
from repro_torch.configs import TDVMMLayerConfig as TLayer
from repro_torch.configs import TDVMMPlan as TPlan
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke as tsmoke
from repro_torch.configs import tdvmm_rule as trule
from repro_torch.core import calibration as tcalib
from repro_torch.core import layers as tlayers
from repro_torch.core.nonideal import NonIdealityConfig
from repro_torch.kernels import _build
from repro_torch.kernels.tdvmm import tdvmm as tk
from repro_torch.models import attention
from repro_torch.models import model as tmodel
from repro_torch.runtime import fault
from repro_torch.runtime import faultinject as fi
from repro_torch.runtime.engine import (DeviceFault, DriftConfig, Engine,
                                        EngineConfig, FaultConfig, Request)


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


# the JAX package's fault tests' engine shape and trace (tests/test_fault.py)
ECFG = dict(slots=3, page_size=4, num_pages=32, chunk=4)
DRIFT = dict(sigma_tune=0.5, repeats=3)      # test_fault's drifted weights


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


@functools.lru_cache(maxsize=None)
def _served():
    """(jax cfg, port cfg, jax params, port params, jax calib, port calib,
    calibration batch) of the smoke qwen under ``ffn.*``."""
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
    tcal = tmodel.calibrate(tparams, {"inputs": torch.from_numpy(tokens)}, tc,
                            max_len=48, device="cpu")
    for site in jcal.windows:
        np.testing.assert_array_equal(tcal.windows[site].numpy(),
                                      np.asarray(jcal.windows[site]))
    return jc, tc, jparams, tparams, jcal, tcal, tokens


@functools.lru_cache(maxsize=None)
def _baselines():
    """The unbroken runs of the trace: (trace, JAX report, port report)."""
    jc, tc, jparams, tparams, jcal, tcal, _ = _served()
    trace = _trace(jc.vocab_size)
    jrep = jengine.Engine(jc, jparams, jengine.EngineConfig(**ECFG),
                          calib=jcal).run([jengine.Request(**r)
                                           for r in trace])
    trep = Engine(tc, tparams, EngineConfig(**ECFG), calib=tcal,
                  device="cpu").run([Request(**r) for r in trace])
    return [Request(**r) for r in trace], jrep, trep


def _engine(calib=None, params=None, ecfg=None):
    _, tc, _, tparams, _, tcal, _ = _served()
    return Engine(tc, tparams if params is None else params,
                  EngineConfig(**ECFG) if ecfg is None else ecfg,
                  calib=tcal if calib is None else calib, device="cpu")


def _same_streams(a, b):
    for ra, rb in zip(a.requests, b.requests):
        assert ra["tokens"] == rb["tokens"], (ra, rb)
        assert ra["finish_reason"] == rb["finish_reason"], (ra, rb)
        assert ra["finished_step"] == rb["finished_step"], (ra, rb)
    assert a.steps == b.steps


# --------------------------------------------------------------------------
# Against the JAX package
# --------------------------------------------------------------------------
def test_unbroken_streams_match_reference_engine():
    _, jrep, trep = _baselines()
    _same_streams(jrep, trep)
    assert trep.step_shapes == 2 and trep.preempted is False
    assert trep.failed == trep.step_retries == trep.recalibrations == 0


def test_kill_at_every_step_resumes_to_reference_streams(tmp_path):
    reqs, jbase, _ = _baselines()
    # two engines reused for every k: the victim also shows that run()
    # starts afresh after a preempted run
    victim, survivor = _engine(), _engine()
    for k in range(jbase.steps):
        rep = victim.run(reqs, FaultConfig(
            injector=fi.FaultInjector([fi.PreemptAt(k)]),
            snapshot_dir=str(tmp_path), snapshot_keep=1))
        assert rep.preempted and rep.steps == k, (k, rep.steps)
        assert rep.snapshot_path is not None
        flat, step = checkpoint.load_engine_snapshot(tmp_path, step=k)
        assert step == k
        survivor.restore(flat)
        resumed = survivor.resume()
        assert not resumed.preempted
        _same_streams(jbase, resumed)
        assert resumed.step_shapes <= 2
    _same_streams(jbase, victim.run(reqs))


def _drifted(jc, tc, jparams):
    """The JAX package's drifted weights (its fault tests' DriftAt), and
    the same weights converted for the port."""
    jd = jfi.drift_params(jparams, jax.random.PRNGKey(0), jfi._model_spec(jc),
                          JNonIdeal(dibl=False, weight_noise=True,
                                    sigma_tune=DRIFT["sigma_tune"]),
                          repeats=DRIFT["repeats"])
    return jd, convert.params_from_numpy(jax.tree.map(np.asarray, jd), tc,
                                         "cpu")


def _probe_setup(kind: str):
    """(jax cfg, port cfg, jax params, port params, tokens, sites, shape)."""
    if kind == "scalar":
        jc, tc, jparams, tparams, *_ = _served()
        return (jc, tc, jparams, tparams,
                np.random.default_rng(3).integers(0, jc.vocab_size, (2, 12)),
                ("ffn.in", "ffn.out"), ())
    if kind == "per_expert":
        jc = jsmoke(jget("mixtral-8x7b")).replace(tdvmm_plan=JPlan(
            (jrule("moe.*", enabled=True, backend="jnp"),)))
        tc = tsmoke(tget("mixtral-8x7b")).replace(tdvmm_plan=TPlan(
            (trule("moe.*", enabled=True),)))
        shape = (tc.moe.n_experts,)
        sites = ("moe.expert.in", "moe.expert.out")
    else:                                        # the attention qkv group
        jc = jsmoke(jget("qwen1.5-0.5b")).replace(tdvmm_plan=JPlan(
            (jrule("attn.qkv", enabled=True, backend="jnp"),)))
        tc = tsmoke(tget("qwen1.5-0.5b")).replace(tdvmm_plan=TPlan(
            (trule("attn.qkv", enabled=True),)))
        shape, sites = (3,), ("attn.qkv",)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jc)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), tc,
                                        "cpu")
    tokens = np.random.default_rng(3).integers(0, jc.vocab_size, (2, 12))
    return jc, tc, jparams, tparams, tokens, sites, shape


@pytest.mark.parametrize("kind", ["scalar", "per_expert", "grouped"])
def test_drift_probe_matches_reference(kind):
    """Probed on the JAX package's drifted weights against windows pinned
    at a quarter of the clean ones (so that elements clip): the fresh windows
    bitwise, the clip rates and the window ratios exactly equal; the clean
    weights probed against their own windows: nothing clips."""
    jc, tc, jparams, tparams, tokens, sites, shape = _probe_setup(kind)
    jb, tb = {"inputs": jnp.asarray(tokens)}, {"inputs": torch.from_numpy(tokens)}
    jpin = jmodel.calibrate(jparams, jb, jc)
    tpin = tmodel.calibrate(tparams, tb, tc, device="cpu")
    assert tpin.sites() == jpin.sites() == tuple(sorted(sites))
    quarter = np.float32(0.25)
    jstale = jcalib.CalibrationState(windows={
        s: jnp.asarray(np.asarray(v) * quarter) for s, v in jpin.windows.items()})
    tstale = tcalib.CalibrationState(windows={
        s: v * quarter for s, v in tpin.windows.items()})
    jd, td = _drifted(jc, tc, jparams)
    jfresh, jclips = jmodel.drift_probe(jd, jb, jc, jstale)
    tfresh, tclips = tmodel.drift_probe(td, tb, tc, tstale, device="cpu")
    assert tfresh.sites() == jfresh.sites()
    for site in sites:
        assert tuple(tfresh.windows[site].shape) == shape
        np.testing.assert_array_equal(tfresh.windows[site].numpy(),
                                      np.asarray(jfresh.windows[site]))
    assert tclips == jclips
    assert max(tclips.values()) > 0.0              # the drift clips
    assert tcalib.clip_rate_metrics(tclips) == jcalib.clip_rate_metrics(jclips)
    assert tstale.drift_ratios(tfresh) == jstale.drift_ratios(jfresh)
    assert tcalib.last_clips().keys() == jcalib.last_clips().keys()
    for site, v in tcalib.last_clips().items():
        np.testing.assert_array_equal(v, jcalib.last_clips()[site])
    # the clean weights against their own windows: nothing clips
    same, clean = tmodel.drift_probe(tparams, tb, tc, tpin, device="cpu")
    assert all(v == 0.0 for v in clean.values()) and clean.keys() == set(sites)
    assert tpin.drift_ratios(same) == dict.fromkeys(sites, 1.0)


def _layer_case(form: str, seed: int = 0):
    """(site, jax call, port call) of one TD-VMM layer in ``form``."""
    rng = np.random.default_rng(seed)
    if form == "scalar":
        x = rng.standard_normal((5, 24)).astype(np.float32)
        w = (rng.standard_normal((24, 40)) * 24 ** -0.5).astype(np.float32)
        return ("ffn.in",
                lambda c: jlayers.td_matmul(jnp.asarray(x), jnp.asarray(w), c),
                lambda c: tlayers.td_matmul(torch.from_numpy(x),
                                            torch.from_numpy(w), c))
    if form == "per_tile":
        x = rng.standard_normal((4, 7, 32)).astype(np.float32)
        x[:, 5:] = 0.0                     # capacity padding
        x[1] = 0.0                         # an expert with no token
        w = (rng.standard_normal((4, 32, 40)) * 32 ** -0.5).astype(np.float32)
        return ("moe.expert.in",
                lambda c: jlayers.td_expert_matmul(jnp.asarray(x),
                                                   jnp.asarray(w), c),
                lambda c: tlayers.td_expert_matmul(torch.from_numpy(x),
                                                   torch.from_numpy(w), c))
    x = rng.standard_normal((2, 3, 24)).astype(np.float32)
    ws = [(rng.standard_normal((24, n)) * 24 ** -0.5).astype(np.float32)
          for n in (40, 40, 16, 16, 4)]     # ssm.in_proj's ragged members
    return ("ssm.in_proj",
            lambda c: jlayers.td_grouped_matmul(
                jnp.asarray(x), [jnp.asarray(w) for w in ws], c),
            lambda c: tlayers.td_grouped_matmul(
                torch.from_numpy(x), [torch.from_numpy(w) for w in ws], c))


@pytest.mark.parametrize("form", ["scalar", "per_tile", "group_widths"])
def test_layer_clip_tally_matches_reference(form):
    """Each window form's clip tally, pinned at 0.6 of the captured window
    (some elements clip): the (exceed, total) pairs equal the JAX
    package's."""
    site, jcall, tcall = _layer_case(form)
    with jcalib.collect() as got:
        jcall(JLayer(enabled=True, site=site, backend="jnp"))
    pinned = np.array(got[site], np.float32) * np.float32(0.6)
    with jcalib.collect(pinned={site: pinned}):
        jcall(JLayer(enabled=True, site=site, backend="jnp"))
    with tcalib.collect(pinned={site: torch.tensor(pinned)}) as tgot:
        tcall(TLayer(enabled=True, site=site))
    np.testing.assert_array_equal(tgot[site], np.asarray(got[site]))
    want, have = jcalib.last_clips()[site], tcalib.last_clips()[site]
    assert have.dtype == np.float64 and 0.0 < have[0] < have[1]
    np.testing.assert_array_equal(have, want)


def test_calibration_helpers_match_reference():
    tallies = {"ffn.out": np.array([3.0, 40.0]), "ffn.in": np.array([0.0, 0.0])}
    assert tcalib.clip_rates(tallies) == jcalib.clip_rates(tallies)
    rates = tcalib.clip_rates(tallies)
    assert list(tcalib.clip_rate_metrics(rates)) == \
        ["clip_rate.ffn.in", "clip_rate.ffn.out"]
    assert tcalib.runtime_window_map() is None
    win = {"ffn.in": torch.tensor(0.5)}
    with tcalib.runtime_windows(win):
        assert tcalib.runtime_window_map() == win
    pinned = tcalib.CalibrationState(windows={
        "a": torch.tensor(2.0), "b": torch.tensor([1.0, 4.0])})
    fresh = tcalib.CalibrationState(windows={
        "a": torch.tensor(3.0), "b": torch.tensor([1.0, 1.0])})
    jp = jcalib.CalibrationState(windows={k: jnp.asarray(v.numpy())
                                          for k, v in pinned.windows.items()})
    jf = jcalib.CalibrationState(windows={k: jnp.asarray(v.numpy())
                                          for k, v in fresh.windows.items()})
    assert pinned.drift_ratios(fresh) == jp.drift_ratios(jf) == \
        {"a": 1.5, "b": 0.25}
    with pytest.raises(ValueError, match="structure changed"):
        pinned.drift_ratios(tcalib.CalibrationState(
            windows={"a": torch.ones(2)}))


# --------------------------------------------------------------------------
# The port's engine on its own (tests/test_fault.py's engine tests)
# --------------------------------------------------------------------------
def test_in_memory_snapshot_round_trip():
    reqs, _, base = _baselines()
    e1 = _engine()
    r1 = e1.run(reqs, FaultConfig(injector=fi.FaultInjector([fi.PreemptAt(2)])))
    assert r1.preempted
    snap = e1.snapshot()
    # the snapshot is a copy: the victim's pools move on, the snapshot not
    before = {k: v.clone() for k, v in checkpoint.leaf_paths(snap)}
    e1.resume()
    for k, v in checkpoint.leaf_paths(snap):
        assert torch.equal(v, before[k]), k
    e2 = _engine()
    e2.restore(snap)
    _same_streams(base, e2.resume())


def test_snapshot_ecfg_mismatch_raises():
    reqs, _, _ = _baselines()
    e1 = _engine()
    e1.run(reqs, FaultConfig(injector=fi.FaultInjector([fi.PreemptAt(2)])))
    other = _engine(ecfg=EngineConfig(slots=2, page_size=4, num_pages=32,
                                      chunk=4))
    with pytest.raises(ValueError, match="EngineConfig"):
        other.restore(e1.snapshot())


def test_transient_failure_retried_streams_unchanged():
    reqs, _, base = _baselines()
    rep = _engine().run(reqs, FaultConfig(
        injector=fi.FaultInjector([fi.FailStep(step=2, kind="any", times=1)]),
        retries=2, backoff_s=0.001))
    assert rep.step_retries == 1 and rep.failed == 0
    _same_streams(base, rep)


def test_persistent_failure_fails_one_request_neighbors_equal():
    reqs, _, base = _baselines()
    rep = _engine().run(reqs, FaultConfig(
        injector=fi.FaultInjector(
            [fi.FailStep(step=base.steps - 2, kind="any", times=2)]),
        retries=1, backoff_s=0.001))
    failed = [r for r in rep.requests if r["finish_reason"] == "failed"]
    assert len(failed) == 1 and rep.failed == 1 and rep.step_retries == 1
    base_by = {r["rid"]: r for r in base.requests}
    for r in rep.requests:
        if r["finish_reason"] != "failed":
            assert r["tokens"] == base_by[r["rid"]]["tokens"], r["rid"]
            assert r["finish_reason"] == base_by[r["rid"]]["finish_reason"]
    fr = failed[0]
    assert fr["tokens"] == base_by[fr["rid"]]["tokens"][:len(fr["tokens"])]


def test_rid_attributed_failure_blames_that_request():
    reqs, _, base = _baselines()
    rep = _engine().run(reqs, FaultConfig(
        injector=fi.FaultInjector(
            [fi.FailStep(step=base.steps - 2, kind="decode", times=2,
                         rid=reqs[1].rid)]),
        retries=1, backoff_s=0.001))
    assert [r["rid"] for r in rep.requests
            if r["finish_reason"] == "failed"] == [reqs[1].rid]


def _torch_illegal_address():
    raise RuntimeError("CUDA error: an illegal memory access was encountered")


@pytest.mark.parametrize("raise_it, match", [
    # torch's own op after a fault: known by its text
    (_torch_illegal_address, "illegal memory access"),
    # a kernel wrapper's launch after a fault (cudaErrorIllegalAddress)
    (lambda: _build.check_launch(700, "tdvmm_fused"), "CUDA error 700"),
    # a launch the card refuses (cudaErrorInvalidValue): not sticky, but it
    # fails again at the same shapes
    (lambda: _build.check_launch(1, "tdvmm_fused"), "CUDA error 1 "),
], ids=["torch-text", "launch-700", "launch-1"])
def test_context_poisoning_cuda_error_is_not_retried(monkeypatch, raise_it,
                                                     match):
    reqs, _, _ = _baselines()
    calls = []

    def broken(*args, **kw):
        calls.append(1)
        raise_it()

    # the B1 wrapper every pinned-window step launches
    monkeypatch.setattr(tk, "tdvmm_fused", broken)
    eng = _engine()
    with pytest.raises(DeviceFault, match=match):
        eng.run(reqs, FaultConfig(retries=3, backoff_s=0.001))
    assert calls == [1] and eng.report().step_retries == 0
    assert eng.report().failed == 0


def test_cuda_errors_classified_by_number():
    sticky = _build.LaunchError("tdvmm_matmul_raw", 700)
    assert _build.poisons_context(sticky) and sticky.code == 700
    assert all(_build.poisons_context(_build.LaunchError("b", c))
               for c in (214, 710, 716, 719))
    assert not _build.poisons_context(_build.LaunchError("b", 1))
    assert not _build.poisons_context(RuntimeError("CUDA out of memory"))
    with pytest.raises(_build.LaunchError, match="ssd_scan: CUDA error 719"):
        _build.check_launch(719, "ssd_scan")
    _build.check_launch(0, "ssd_scan")


def test_kernel_build_failure_ends_the_run(monkeypatch):
    reqs, _, _ = _baselines()
    calls = []

    def unbuilt(*args, **kw):
        calls.append(1)
        raise _build.BuildError("nvcc failed for tdvmm.cu")

    monkeypatch.setattr(tk, "tdvmm_fused", unbuilt)
    eng = _engine()
    with pytest.raises(_build.BuildError, match="nvcc failed"):
        eng.run(reqs, FaultConfig(retries=3, backoff_s=0.001))
    assert calls == [1] and eng.report().step_retries == 0
    assert eng.report().failed == 0


def _drift_cfg():
    *_, tokens = _served()
    return DriftConfig(probe_batch={"inputs": torch.from_numpy(tokens)},
                       check_every=4, clip_threshold=0.005, window_tol=0.05)


def test_drift_recalibrates_in_place():
    _, tc, _, _, _, tcal, _ = _served()
    reqs = [Request(**r) for r in _trace(tc.vocab_size, n=6, seed=5)]
    eng = _engine()
    ptrs = {s: t.data_ptr() for s, t in eng._windows.items()}
    rep = eng.run(reqs, FaultConfig(
        injector=fi.FaultInjector([fi.DriftAt(step=4, **{
            "sigma": DRIFT["sigma_tune"], "repeats": DRIFT["repeats"]})]),
        drift=_drift_cfg()))
    assert rep.recalibrations >= 1, rep.drift_events
    ev = rep.drift_events[0]
    assert ev["max_log_ratio"] > 0.05 or ev["max_clip_rate"] > 0.005
    # every probe is on the report, the drifted one among them
    check = {c["step"]: c for c in rep.drift_checks}[ev["step"]]
    assert (check["max_clip_rate"], check["max_log_ratio"]) == \
        (ev["max_clip_rate"], ev["max_log_ratio"])
    assert rep.step_shapes == 2                  # no third step shape
    # the same tensors, new values; the caller's calibration untouched
    assert {s: t.data_ptr() for s, t in eng._windows.items()} == ptrs
    moved = eng.pinned_calibration().drift_ratios(tcal)
    assert any(abs(np.log(max(r, 1e-12))) > 1e-6 for r in moved.values())
    for site, t in _served()[5].windows.items():
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(_served()[4].windows[site]))


def test_no_drift_no_false_positive():
    _, tc, *_ = _served()
    reqs = [Request(**r) for r in _trace(tc.vocab_size, n=6, seed=5)]
    rep = _engine().run(reqs, FaultConfig(drift=_drift_cfg()))
    assert rep.recalibrations == 0 and rep.drift_events == []
    assert len(rep.drift_checks) == rep.steps // _drift_cfg().check_every
    assert rep.step_shapes == 2


def test_snapshot_carries_recalibrated_windows():
    """Preempted after a recalibration, the snapshot carries the swapped
    windows: an engine built on the stale ones and restored from it
    finishes like the drifted model served from the start."""
    jc, tc, jparams, _, _, tcal, tokens = _served()
    reqs = [Request(**r) for r in _trace(tc.vocab_size, n=6, seed=5)]
    _, drifted = _drifted(jc, tc, jparams)
    fresh = tmodel.calibrate(drifted, {"inputs": torch.from_numpy(tokens)},
                             tc, max_len=48, device="cpu")
    base = _engine(calib=fresh, params=drifted).run(reqs)
    e1 = _engine(calib=fresh, params=drifted)
    e1.run(reqs, FaultConfig(
        injector=fi.FaultInjector([fi.PreemptAt(base.steps // 2)])))
    e2 = _engine(calib=tcal, params=drifted)
    e2.restore(e1.snapshot())
    got = e2.pinned_calibration().windows
    for site, t in fresh.windows.items():
        np.testing.assert_array_equal(got[site].numpy(), t.numpy())
    _same_streams(base, e2.resume())


def test_monitor_and_heartbeat_feed_report(tmp_path):
    reqs, _, base = _baselines()
    hb = fault.Heartbeat(tmp_path / "hb.json", every_s=0.0)
    mon = fault.StragglerMonitor()
    rep = _engine().run(reqs, FaultConfig(heartbeat=hb, monitor=mon))
    _same_streams(base, rep)
    assert rep.heartbeats >= rep.steps
    assert rep.straggler_ewma_s > 0.0
    assert rep.stragglers == mon.stragglers


def test_slowstep_fires_once_and_keeps_streams():
    reqs, _, base = _baselines()
    ev = fi.SlowStep(step=2, sleep_s=0.05, kind="any")
    t0 = time.perf_counter()
    rep = _engine().run(reqs, FaultConfig(injector=fi.FaultInjector([ev])))
    assert time.perf_counter() - t0 >= 0.05
    assert ev.fired and not ev.matches("decode", 2)
    _same_streams(base, rep)
    assert not fi.SlowStep(step=0, kind="prefill").matches("decode", 0)


@pytest.mark.parametrize("piece", ["sla", "telemetry", "trace"])
def test_restore_refuses_state_the_port_does_not_hold(piece):
    """The JAX package's three restore guards: a snapshot taken under an SLA
    policy the restoring engine does not run, or carrying telemetry or
    trace state that engine has no sink or tracer to take, is refused
    before anything changes."""
    from repro_torch.runtime import sla, telemetry, trace
    reqs, _, _ = _baselines()
    _, tc, _, tparams, _, tcal, _ = _served()
    kw = {"sla": dict(sla=sla.SlaConfig()),
          "telemetry": dict(sink=telemetry.MetricsSink()),
          "trace": dict(tracer=trace.Tracer())}[piece]
    e1 = Engine(tc, tparams, EngineConfig(**ECFG), calib=tcal, device="cpu",
                **kw)
    e1.run(reqs, FaultConfig(injector=fi.FaultInjector([fi.PreemptAt(3)])))
    snap = e1.snapshot()
    sink, tracer = telemetry.MetricsSink(), trace.Tracer()
    # restoring engines that lack what the snapshot needs (the SLA case:
    # another policy, and none); the sink and tracer they do have stay fresh
    others = {"sla": [dict(sla=sla.SlaConfig(aging_steps=3)), {}],
              "telemetry": [dict(tracer=tracer)],
              "trace": [dict(sink=sink)]}[piece]
    match = {"sla": "SLA policy", "telemetry": "no sink",
             "trace": "no tracer"}[piece]
    for other in others:
        e2 = Engine(tc, tparams, EngineConfig(**ECFG), calib=tcal,
                    device="cpu", **other)
        with pytest.raises(ValueError, match=match):
            e2.restore(snap)
        assert e2._st is None                      # nothing was changed
    assert sink.observations == 0 and sink.series == {}
    assert tracer.events == trace.Tracer().events and tracer.ticks == 0


def test_kill_and_resume_with_int8_page_pools(tmp_path):
    """int8 page pools (codes and float32 scales) ride the snapshot; a bf16
    engine refuses them."""
    reqs, _, _ = _baselines()
    attention.set_kv_cache_int8(True)
    try:
        base = _engine().run(reqs)
        for k in (2, base.steps // 2, base.steps - 1):
            victim = _engine()
            rep = victim.run(reqs, FaultConfig(
                injector=fi.FaultInjector([fi.PreemptAt(k)]),
                snapshot_dir=str(tmp_path), snapshot_keep=1))
            assert rep.preempted
            flat, _ = checkpoint.load_engine_snapshot(tmp_path, step=k)
            assert flat["caches/seg0/k"].dtype == torch.int8
            assert flat["caches/seg0/k_scale"].dtype == torch.float32
            survivor = _engine()
            survivor.restore(flat)
            assert survivor._st.caches["seg0"].k_scale is not None
            _same_streams(base, survivor.resume())
    finally:
        attention.set_kv_cache_int8(False)
    with pytest.raises(ValueError, match="page pools"):
        _engine().restore(flat)


# --------------------------------------------------------------------------
# Checkpoints of windows and snapshots
# --------------------------------------------------------------------------
def test_calibration_checkpoint_round_trip(tmp_path):
    *_, tcal, _ = _served()
    assert checkpoint.latest_calibration_step(tmp_path) is None
    checkpoint.save_calibration(tcal, tmp_path, step=3)
    assert checkpoint.latest_calibration_step(tmp_path) == 3
    like = tcalib.CalibrationState(windows={
        s: torch.zeros_like(t) for s, t in tcal.windows.items()})
    got, step = checkpoint.restore_calibration(like, tmp_path)
    assert step == 3 and isinstance(got, tcalib.CalibrationState)
    assert got.sites() == tcal.sites()
    for s in tcal.sites():
        assert torch.equal(got.windows[s], tcal.windows[s])


def test_engine_snapshot_checkpoint_round_trip_and_checksum(tmp_path):
    reqs, _, _ = _baselines()
    e1 = _engine()
    e1.run(reqs, FaultConfig(injector=fi.FaultInjector([fi.PreemptAt(5)])))
    snap = e1.snapshot()
    checkpoint.save_engine_snapshot(snap, tmp_path, step=5)
    assert checkpoint.latest_engine_snapshot_step(tmp_path) == 5
    flat, step = checkpoint.load_engine_snapshot(tmp_path)
    want = dict(checkpoint.leaf_paths(snap))
    assert step == 5 and flat.keys() == want.keys()
    for k, v in want.items():
        assert flat[k].dtype == v.dtype and torch.equal(flat[k], v), k
    state = tmp_path / "engine" / "step_00000005" / "state.pt"
    raw = bytearray(state.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    state.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="checksum"):
        checkpoint.load_engine_snapshot(tmp_path)


def test_drift_params_perturbs_the_reference_leaves():
    """The leaves the JAX package's drift_params perturbs (two or more dims
    in its stacked layout: per-layer vectors too), in float32, cast back;
    the input untouched; the same seed, the same draws."""
    _, tc, _, tparams, *_ = _served()
    nicfg = NonIdealityConfig(dibl=False, weight_noise=True, sigma_tune=0.5)
    spec = fi._model_spec(tc)
    a = fi.drift_params(tparams, 7, spec, nicfg, repeats=2)
    b = fi.drift_params(tparams, 7, spec, nicfg, repeats=2)
    assert a["embed"] is tparams["embed"]          # outside the subtree
    for (name, x), (_, y), (_, z) in zip(
            checkpoint.leaf_paths(tparams["blocks"]),
            checkpoint.leaf_paths(a["blocks"]),
            checkpoint.leaf_paths(b["blocks"])):
        assert y.dtype == x.dtype and torch.equal(y, z), name
        if bool(x.abs().sum() > 0):                # a zero leaf stays zero
            assert not torch.equal(x, y), name


# --------------------------------------------------------------------------
# The serve CLI's fault flags
# --------------------------------------------------------------------------
CLI = ["--arch", "qwen1.5-0.5b", "--smoke", "--tdvmm", "ffn.*", "--calibrate",
       "--device", "cpu", "--requests", "4", "--prompt-len", "12", "--gen",
       "6", "--chunk", "4", "--page-size", "4", "--num-pages", "32"]


def test_cli_preempt_then_resume_equals_unbroken(tmp_path, capsys):
    from repro_torch.launch import serve
    whole = serve.main(CLI)
    first = serve.main(CLI + ["--preempt-at", "7", "--snapshot-dir",
                              str(tmp_path)])
    out = capsys.readouterr().out
    assert first.preempted and first.steps == 7
    assert "PREEMPTED at step 7" in out
    rest = serve.main(CLI + ["--resume", "--snapshot-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "resumed from snapshot step 7" in out
    _same_streams(whole, rest)
    assert [ln for ln in out.splitlines() if "req " in ln] == [
        f"[serve]   req {r['rid']}: {r['finish_reason']} "
        f"tokens={r['tokens'][:8]}" for r in whole.requests[:4]]


def test_cli_faults_and_drift_flags(tmp_path, capsys):
    from repro_torch.launch import serve
    whole = serve.main(CLI)
    rep = serve.main(CLI + ["--fail-at", "3", "--fail-times", "1",
                            "--slow-at", "4", "--slow-sleep", "0.01",
                            "--heartbeat", str(tmp_path / "hb.json"),
                            "--heartbeat-every", "0"])
    assert rep.step_retries == 1 and rep.failed == 0 and rep.heartbeats > 0
    _same_streams(whole, rep)
    rep = serve.main(CLI + ["--fail-at", "3", "--fail-times", "3",
                            "--retries", "2", "--fail-kind", "any"])
    assert rep.failed == 1
    rep = serve.main(CLI + ["--drift-at", "4", "--drift-check-every", "4",
                            "--drift-tol", "0.05", "--drift-clip", "0.005"])
    assert rep.recalibrations >= 1 and rep.step_shapes == 2
    assert "online recalibrations" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="requires --calibrate"):
        serve.main([a for a in CLI if a != "--calibrate"]
                   + ["--drift-check-every", "4"])
