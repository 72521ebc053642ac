"""Pipeline parallelism on a 2 x 2 x 2 gloo world (8 CPU processes) against
the JAX package's plain forward, and the (1, 1) mesh — a world of one —
against the meshless port, bitwise (``torch_dist_cases.World``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_cases as cases
from repro.configs import get_config as jget
from repro.configs import smoke as jsmoke
from repro.configs import TDVMMPlan as JPlan
from repro.configs import tdvmm_rule as jrule
from repro.models import model as jmodel
from torch_dist_cases import World

# PP logits against the JAX plain forward, relative to max|logit|: the
# stages run the same float32 algebra (tensor-parallel inside a stage, so
# the row-parallel sums take another order); measured 3.1e-6 absolute
# against the port's own forward.  The JAX test's bound is 2e-2 absolute.
PP_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def test_pp_2x2x2_equals_plain_forward():
    cfg = jsmoke(jget("yi-34b")).replace(n_layers=4)
    params = jmodel.init_params(jax.random.PRNGKey(0), cfg)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0,
                                           cfg.vocab_size), np.int32)
    want, _ = jmodel.forward(params, {"inputs": jnp.asarray(tokens),
                                      "targets": jnp.asarray(tokens)}, cfg)
    want = np.asarray(want, np.float32)
    with World(8, timeout=180.0) as w:
        outs = w.run(cases.pp_2x2x2, jax.tree.map(np.asarray, params),
                     tokens, 4)
    for out in outs:                    # the head is replicated
        assert np.array_equal(out, outs[0])
    assert _rel(outs[0], want) <= PP_RTOL
    assert np.max(np.abs(outs[0] - want)) < 2e-2
    assert np.array_equal(outs[0].argmax(-1), want.argmax(-1))


def test_1x1_mesh_engine_and_train_step_are_bitwise_meshless(tmp_path):
    """A (1, 1) mesh is no mesh: the engine on the JAX engine test's trace
    (tests/test_engine.py's mesh test) gives the same streams, finish
    reasons, finish steps, steps and page high-water, 2 step shapes,
    ``devices == 1`` and a dp-1 snapshot; one training step gives the same
    state and metrics, bitwise."""
    cfg = jsmoke(jget("qwen1.5-0.5b")).replace(tdvmm_plan=JPlan(
        rules=(jrule("ffn.*", enabled=True, backend="jnp"),)))
    params = jmodel.init_params(jax.random.PRNGKey(0), cfg)
    batch = {"inputs": jax.random.randint(
        jax.random.PRNGKey(1), (2, 12), 0, cfg.vocab_size)}
    calib = jmodel.calibrate(params, batch, cfg, max_len=48)
    rng = np.random.default_rng(5)
    reqs, arrival = [], 0
    for rid in range(6):
        reqs.append(dict(
            rid=rid, prompt=tuple(int(t) for t in rng.integers(
                0, cfg.vocab_size, int(rng.integers(3, 13)))),
            max_new_tokens=int(rng.integers(2, 8)), arrival_step=arrival))
        arrival += int(rng.integers(0, 2))
    spec = {"ecfg": dict(slots=3, page_size=4, num_pages=32, chunk=4),
            "requests": reqs}
    tparams = jmodel.init_params(jax.random.PRNGKey(2),
                                 jsmoke(jget("qwen1.5-0.5b")))
    with World(1, timeout=180.0) as w:
        r = w.run(cases.world_of_one, jax.tree.map(np.asarray, params),
                  {k: np.asarray(v) for k, v in calib.windows.items()}, spec,
                  jax.tree.map(np.asarray, tparams),
                  dict(name="small", seq_len=16, global_batch=4,
                       kind="train", microbatch_per_shard=4),
                  dict(lr=1e-3, warmup_steps=1, total_steps=3),
                  str(tmp_path))[0]
    e = r["engine"]
    assert e["meshed"] == e["base"]
    assert e["steps"][0] == e["steps"][1]
    assert e["page_high_water"][0] == e["page_high_water"][1]
    assert e["step_shapes"] == 2
    assert e["devices"] == 1 and e["total_slots"] == 3
    assert e["snap_dp"] == 1 and e["snap_free_lists"] == 1
    assert r["train_same"] and r["train_metrics"]
