"""The port's engine in mesh mode on a 2 x 2 gloo world of CPU processes
(``torch_dist_cases.World``, spawned once for the file): the
kill/restore contract of the JAX package's mesh test
(tests/test_fault.py's ``test_mesh_2x2_kill_restore_matches_unsharded_
restore``) against the meshless port and the JAX package's meshless
engine, a trace that fills every data rank's slots, the snapshot's ``dp``
rule, and the per-rank page pool."""
import jax
import numpy as np
import pytest

import torch_dist_cases as cases
from repro.configs import TDVMMPlan as JPlan
from repro.configs import get_config as jget
from repro.configs import smoke as jsmoke
from repro.configs import tdvmm_rule as jrule
from repro.models import model as jmodel
from repro.runtime import faultinject as jfi
from repro.runtime.engine import Engine as JEngine
from repro.runtime.engine import EngineConfig as JEcfg
from repro.runtime.engine import FaultConfig as JFault
from repro.runtime.engine import Request as JRequest
from repro.runtime.sla import SlaConfig as JSla
from repro.runtime.telemetry import MetricsSink as JSink
from torch_dist_cases import World
from repro_torch.runtime.paged_cache import PagePool


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module")
def world():
    with World(4, timeout=180.0) as w:
        yield w


@pytest.fixture(scope="module")
def served():
    """The JAX package's smoke qwen under ``ffn.*`` and its calibration,
    as numpy (the port's engines run on the same weights and windows)."""
    cfg = jsmoke(jget("qwen1.5-0.5b")).replace(tdvmm_plan=JPlan(
        rules=(jrule("ffn.*", enabled=True, backend="jnp"),)))
    params = jmodel.init_params(jax.random.PRNGKey(0), cfg)
    batch = {"inputs": jax.random.randint(
        jax.random.PRNGKey(1), (2, 12), 0, cfg.vocab_size)}
    calib = jmodel.calibrate(params, batch, cfg, max_len=48)
    return (cfg, params, calib, jax.tree.map(np.asarray, params),
            {k: np.asarray(v) for k, v in calib.windows.items()})


def _jax_kill_restore(cfg, params, calib, slots, kill):
    """The JAX package's meshless kill/restore on the same trace."""
    ecfg = JEcfg(slots=slots, page_size=4, num_pages=32, chunk=4)
    sla = JSla(aging_steps=8)
    rng = np.random.default_rng(0)
    reqs, arrival = [], 0
    for rid in range(4):
        reqs.append(JRequest(
            rid=rid, prompt=tuple(int(t) for t in rng.integers(
                0, cfg.vocab_size, rng.integers(3, 11))),
            max_new_tokens=int(rng.integers(2, 6)),
            arrival_step=arrival, priority=rid % 3))
        arrival += int(rng.integers(0, 2))
    e_tok = JEngine(cfg, params, ecfg,
                    calib=calib).energy["energy_per_token_j"]
    reqs.append(JRequest(rid=900, prompt=tuple(range(1, 9)),
                         max_new_tokens=20, deadline_steps=1, arrival_step=1))
    reqs.append(JRequest(rid=901, prompt=tuple(range(9, 15)),
                         max_new_tokens=6, arrival_step=2,
                         joule_budget=(6 + 2.5) * e_tok))
    victim = JEngine(cfg, params, ecfg, calib=calib, sla=sla, sink=JSink())
    victim.run(reqs, JFault(injector=jfi.FaultInjector([jfi.PreemptAt(kill)])))
    survivor = JEngine(cfg, params, ecfg, calib=calib, sla=sla, sink=JSink())
    survivor.restore(victim.snapshot())
    resumed = survivor.resume()
    return [[q["rid"], q["tokens"], q["finish_reason"], q["finished_step"]]
            for q in resumed.requests]


def test_2x2_kill_restore_matches_the_meshless_kill_restore(world, served):
    """Killed mid-trace on 2 x 2 and restored from its snapshot, the engine
    resumes to the streams, step count, SLA outcomes and telemetry series
    (at the restore point) of the meshless kill and restore — the port's
    and, for the streams, the JAX package's."""
    cfg, params, calib, np_params, windows = served
    kill = 7
    solo = world.run(cases.engine_kill_restore, np_params, windows, 6, kill,
                     None)[0]
    outs = world.run(cases.engine_kill_restore, np_params, windows, 6, kill,
                     (2, 2))
    mesh = outs[0]
    assert all(o["resumed"] == mesh["resumed"] for o in outs)
    for r in (solo, mesh):
        assert r["preempted"]
        assert r["resumed"] == r["base"]
        assert r["resumed_steps"] == r["base_steps"]
        assert r["step_shapes"] == 2
        assert r["rejected"] == 1 and r["over_budget"] == 1
        by_rid = {q[0]: q for q in r["resumed"]}
        assert by_rid[900][2] == "rejected"
        assert by_rid[901][2] == "over_budget"
    assert mesh["resumed"] == solo["resumed"]
    assert mesh["resumed_steps"] == solo["resumed_steps"]
    assert mesh["sink_at_restore"] == solo["sink_at_restore"]
    assert mesh["devices"] == 4 and mesh["total_slots"] == 12
    assert solo["devices"] == 1 and solo["total_slots"] == 6
    assert mesh["snap_dp"] == 2 and mesh["snap_free_lists"] == 2
    assert solo["resumed"] == _jax_kill_restore(cfg, params, calib, 6, kill)


def test_2x2_engine_fills_every_data_rank(world, served):
    """Two slots per data rank and a trace that needs all four: the decode
    rows split over the data axes, the sampled tokens all-gathered, give
    the streams of the meshless engine with four slots."""
    _, _, _, np_params, windows = served
    solo = world.run(cases.engine_kill_restore, np_params, windows, 4, 9,
                     None, True)[0]
    mesh = world.run(cases.engine_kill_restore, np_params, windows, 2, 9,
                     (2, 2), True)[0]
    assert mesh["total_slots"] == solo["total_slots"] == 4
    assert mesh["base"] == solo["base"]
    assert mesh["resumed"] == solo["resumed"] == solo["base"]
    assert mesh["utilization"] == solo["utilization"]
    assert solo["utilization"] > 0.5


def test_snapshot_restores_onto_the_same_dp_only(world, served):
    """Repair: a snapshot taken over 2 data ranks restores onto an engine of
    the same dp (and resumes to its streams); another dp is refused."""
    _, _, _, np_params, windows = served
    for r in world.run(cases.engine_dp_mismatch, np_params, windows):
        assert r["same"]
        assert "data-parallel" in r["refused"]


def test_page_pool_ranks():
    pool = PagePool(num_pages=6, page_size=4, ranks=2)
    assert pool.trash_page == 13 and pool.total_pages == 12
    a = pool.alloc(2, rank=1)
    assert a == [7, 8] and pool.in_use == 2
    assert pool.alloc(5, rank=1) is None
    b = pool.alloc(3)
    assert b == [0, 1, 2] and pool.high_water == 5
    lists = pool.free_lists()
    pool.free(a)
    assert pool.free_lists()[1] == [7, 8, 9, 10, 11, 12]
    pool2 = PagePool(num_pages=6, page_size=4, ranks=2)
    pool2.restore_free(lists)
    assert pool2.free_lists() == lists and pool2.in_use == 5
    with pytest.raises(ValueError, match="rank free-lists"):
        PagePool(num_pages=6, page_size=4).restore_free(lists)
    with pytest.raises(ValueError, match="out-of-range"):
        pool.free([6])                      # a per-rank trash row
    one = PagePool(num_pages=6, page_size=4)
    assert one.trash_page == 6 and one.alloc(2) == [0, 1]


def test_serve_cli_mesh_2x2_equals_meshless():
    """``launch.serve --mesh 2x2`` (the engine path, every rank the same
    command) serves the token streams and finish reasons of the meshless
    CLI (the data axis doubles the slots, so requests finish earlier)."""
    from repro_torch.launch import serve
    argv = ["--arch", "qwen1.5-0.5b", "--smoke", "--tdvmm", "ffn.*",
            "--calibrate", "--device", "cpu", "--requests", "6"]
    solo = serve.main(argv)
    want = [[q["rid"], q["tokens"], q["finish_reason"]]
            for q in solo.requests]
    with World(4, timeout=180.0) as w:
        outs = w.run(cases.serve_cli_2x2, argv)
    for streams, devices, slots in outs:
        assert [q[:3] for q in streams] == want
        assert devices == 4 and slots == 2 * solo.total_slots


@pytest.mark.parametrize("calibrate,batch", [(False, 4), (True, 4),
                                             (False, 3)])
def test_serve_static_on_2x2(world, calibrate, batch):
    """The static path on 2 x 2: each rank's rows and KV heads, the caches
    its shards under ``sharding.cache_specs`` (a batch the data axis does
    not divide stays whole), the same greedy tokens as without a mesh."""
    for solo, meshed, nans in world.run(cases.serve_static_2x2,
                                        "qwen1.5-0.5b", calibrate, batch):
        assert nans == 0
        np.testing.assert_array_equal(meshed, solo)
