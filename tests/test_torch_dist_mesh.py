"""The port's distributed layer on a 2 x 2 gloo world of CPU processes
(``torch_dist_cases.World``, spawned once for the file): sharded
forwards against the JAX package's meshless forward, TD-VMM sites on their
tensor-parallel shards against the meshless sites, the elastic restore,
the int8 error-feedback all-reduce and 3 training steps.

The JAX package's own mesh path does not run under this jax (its
embedding gather stops with ``ShardingTypeError``), so its meshless results
are the oracle, with the same weights through ``convert``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from repro.configs import OptimizerConfig as JOpt
from repro.configs import RunConfig as JRun
from repro.configs import get_config as jget
from repro.configs import smoke as jsmoke
from repro.configs.base import ShapeConfig as JShape
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro.optim import compression as jcomp
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke as tsmoke
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharding
from torch_dist_cases import World
from repro_torch.optim import compression as tcomp
from repro_torch.optim.optimizer import make_optimizer
from repro_torch.configs import OptimizerConfig as TOpt

# 2 x 2 logits against the JAX meshless forward, relative to max|logit|.
# Sharded, the same float32 algebra sums in other orders (row-parallel
# reductions over ``model``, per-shard matmuls): measured <= 6.7e-7 of the
# port's own meshless forward (<= 4.8e-7 under a TD-VMM plan).  TP_EXPLICIT
# casts the partial products to bf16 before their reduction (the JAX
# package's explicit path): measured 0.025-0.027 absolute, under the JAX
# test's own 5e-2 limit.
LOGIT_RTOL = 1e-5
TP_EXPLICIT_ATOL = 5e-2
# three training steps, as tests/test_torch_train.py's TRAIN_RTOL.  The
# gradients average over the data axes in float32 in another order, which
# Adafactor's 1 / sqrt(vhat) carries into the next step's gradient norm:
# measured 1.5e-5 at step 2 (its losses stay within TRAIN_RTOL).
TRAIN_RTOL = 1e-5
ADAFACTOR_GNORM_RTOL = 1e-4
# the same under the int8 all-reduce: the compressed gradient reaches a loss
# through the updates (the first, at warmup's lr 0, moves nothing), so
# steps 0 and 1 are within TRAIN_RTOL and step 2 measured 1.5e-4
INT8_LOSS_RTOL = 1e-3
WORLD_TIMEOUT = 180.0


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module")
def world():
    with World(4, timeout=WORLD_TIMEOUT) as w:
        yield w


@pytest.fixture(scope="module")
def world2():
    with World(2, timeout=WORLD_TIMEOUT) as w:
        yield w


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_cfg(arch):
    cfg = jsmoke(jget(arch)).replace(vocab_pad_multiple=32)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=64.0))
    return cfg


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# --------------------------------------------------------------------------
# 2 x 2 sharded forward against the JAX package's meshless forward
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,explicit", [
    ("mixtral-8x7b", False),        # MoE impl 'local': TP expert FFN
    ("kimi-k2-1t-a32b", False),     # MoE impl 'ep': all_to_all over data
    ("yi-34b", False),
    ("yi-34b", True),               # TP_EXPLICIT: bf16 partial products
    ("qwen1.5-0.5b", False),        # tied head: vocab-split table
])
def test_2x2_forward_matches_jax_meshless(world, arch, explicit):
    jc = _jax_cfg(arch)
    jp = jmodel.init_params(jax.random.PRNGKey(1), jc)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (4, 16), 0,
                                           jc.vocab_size), np.int32)
    want, _ = jmodel.forward(jp, {"inputs": jnp.asarray(tokens),
                                  "targets": jnp.asarray(tokens)}, jc)
    want = np.asarray(want, np.float32)
    outs = world.run(cases.forward_2x2, arch, _np(jp), tokens, explicit)
    r = outs[0]
    assert all(o["agree"] and o["exact"] for o in outs)
    # the port's meshless forward is the JAX package's
    assert _rel(r["ref"], want) <= LOGIT_RTOL
    if explicit:
        assert np.max(np.abs(r["out"] - want)) < TP_EXPLICIT_ATOL
        # greedy tokens agree wherever the meshless top-2 margin exceeds
        # twice the bf16 reductions' bound
        top2 = np.sort(want, -1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > 2 * TP_EXPLICIT_ATOL
        assert clear.any()
        assert np.array_equal(r["out"].argmax(-1)[clear],
                              want.argmax(-1)[clear])
    else:
        assert _rel(r["out"], want) <= LOGIT_RTOL
        assert np.array_equal(r["out"].argmax(-1), want.argmax(-1))
    if jc.moe is not None:
        # the aux losses are averaged over the data axes
        assert np.isfinite(r["aux"]["lb_loss"])


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_ssm_and_hybrid_run_data_and_tensor_parallel(world, arch):
    """Every family runs data-parallel (4 x 1: each rank its row of the
    batch) and tensor-parallel (2 x 2: the SSM heads, x / z channels and
    B / C columns split over ``model``, B and C all-gathered before the
    scan; zamba2's shared block by heads and ``fuse`` by columns), each
    within LOGIT_RTOL of the JAX meshless forward with equal tokens."""
    jc = jsmoke(jget(arch)).replace(vocab_pad_multiple=32)
    jp = jmodel.init_params(jax.random.PRNGKey(1), jc)
    tokens = np.random.default_rng(4).integers(0, jc.vocab_size,
                                               (4, 16)).astype(np.int32)
    want, _ = jmodel.forward(jp, {"inputs": jnp.asarray(tokens),
                                  "targets": jnp.asarray(tokens)}, jc)
    want = np.asarray(want, np.float32)
    for shape in ((4, 1), (2, 2)):
        outs = world.run(cases.forward_2x2, arch, _np(jp), tokens, False, (),
                         None, shape)
        assert all(o["agree"] and o["exact"] for o in outs), shape
        assert _rel(outs[0]["out"], want) <= LOGIT_RTOL, shape
        assert np.array_equal(outs[0]["out"].argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch,rules", [
    ("qwen1.5-0.5b", ("ffn.*",)),
    ("mixtral-8x7b", ("moe.*",)),
    ("kimi-k2-1t-a32b", ("moe.*",)),
])
def test_2x2_forward_under_a_tdvmm_plan(world, arch, rules):
    """The data-calibrated TD-VMM plan on 2 x 2 against the meshless port:
    each site's window is the max over every rank's columns and rows, its
    codes and integer accumulators those of the meshless site (held
    bitwise below); only the float32 parts of the model sum in other
    orders (measured <= 4.8e-7 of max|logit|)."""
    jc = _jax_cfg(arch)
    jp = jmodel.init_params(jax.random.PRNGKey(1), jc)
    tokens = np.random.default_rng(2).integers(0, jc.vocab_size,
                                               (4, 16)).astype(np.int32)
    r = world.run(cases.forward_2x2, arch, _np(jp), tokens, False, rules)[0]
    assert np.isfinite(r["out"]).all()
    assert _rel(r["out"], r["ref"]) <= LOGIT_RTOL
    assert np.array_equal(r["out"].argmax(-1), r["ref"].argmax(-1))


@pytest.mark.parametrize("seed", [0, 1])
def test_tdvmm_sites_on_tp_shards_are_bitwise_the_meshless_sites(world,
                                                                 seed):
    """Column (N split), row (K split: the int32 accumulators summed over
    ``model``, one epilogue), expert-bank and grouped sites, each with a
    data-calibrated window, runtime windows, no readout, a per-tensor
    weight scale and p = 8 float32 codes; the input and weight codes of a
    row site; the calibration capture and its clip tallies."""
    for r in world.run(cases.td_sites_2x2, seed):
        assert r["bad"] == [], r["bad"]
        assert r["held"] == 44          # 5 settings x 7 outputs, 4 codes, 5 sites


def test_elastic_restore_2x2_to_4x1_is_exact(world, tmp_path):
    out = world.run(cases.elastic_restore, str(tmp_path / "ck"))
    for r in out:
        assert r["step"] == 3 and r["exact"] and r["shards_exact"]
        assert r["n_split"] > 10        # the 4 x 1 layout splits leaves


def test_compressed_all_reduce_converges_with_error_feedback(world):
    out = world.run(cases.compressed_reduce, 50)
    for r in out:
        assert r["err_ef"] <= r["err_plain"]
        assert r["err_ef"] < 0.2 * r["err_first"]
    # every rank holds the same mean
    assert all(np.array_equal(out[0]["ef"], r["ef"]) for r in out)


def test_compressed_all_reduce_exchange_is_exact(world):
    """The reduce-scatter of codes and the all-gather of means give the
    bits of every rank's codes summed in rank order: sizes under, at and
    past one block, and block counts the 4 ranks do not divide."""
    out = world.run(cases.compressed_reduce_exchange,
                    (1, 2047, 2048, 3000, 5 * 2048 + 7, 20000))
    assert all(all(r) for r in out)


SMALL_SHAPE = dict(name="small", seq_len=16, global_batch=4, kind="train",
                   microbatch_per_shard=4)


@pytest.mark.parametrize("opt_name,compression", [
    ("adamw", "none"), ("adafactor", "none"), ("adamw", "int8")])
def test_three_training_steps_on_2x2(world, tmp_path, monkeypatch, opt_name,
                                     compression):
    """FSDP + TP state, data-parallel gradient average: the losses of 3
    steps equal the JAX package's meshless ``train_loop`` from the same
    weights and the port's meshless one, within TRAIN_RTOL (with the int8
    all-reduce, within INT8_LOSS_RTOL)."""
    from repro_torch import convert
    from repro_torch.configs import RunConfig as TRun
    from repro_torch.configs.base import ShapeConfig as TShape
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch import train as ttrain
    arch = "qwen1.5-0.5b"
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=3, name=opt_name)
    jc = jsmoke(jget(arch))
    jrun = JRun(model=jc, shape=JShape(**SMALL_SHAPE),
                optimizer=JOpt(**opt), checkpoint_dir=str(tmp_path / "jax"))
    ref = jtrain.train_loop(jrun, 3, log_every=1)
    jp = _np(jrun_params(jc))
    tc = tsmoke(tget(arch))

    def init_state(seed, cfg, optimizer, device=None):
        params = convert.params_from_numpy(jp, tc, "cpu")
        return tsteps.TrainState(params, optimizer.init(params))
    monkeypatch.setattr(tsteps, "init_train_state", init_state)
    solo = ttrain.train_loop(TRun(model=tc, shape=TShape(**SMALL_SHAPE),
                                  optimizer=TOpt(**opt),
                                  checkpoint_dir=str(tmp_path / "solo")),
                             3, log_every=1, device="cpu")
    out = world.run(cases.train_2x2, arch, jp, SMALL_SHAPE, opt,
                    str(tmp_path / "mesh"), compression)
    hist = out[0]["history"]
    timeless = [[{k: v for k, v in h.items() if k != "dt"}
                 for h in o["history"]] for o in out]
    assert all(t == timeless[0] for t in timeless)
    assert len(hist) == 3 and out[0]["step"] == 3
    tol = TRAIN_RTOL if compression == "none" else INT8_LOSS_RTOL
    for a, s, b in zip(hist, solo["history"], ref["history"]):
        for want in (s, b):
            assert abs(a["loss"] - want["loss"]) <= tol * abs(want["loss"])
        if compression == "none":
            rtol = ADAFACTOR_GNORM_RTOL if opt_name == "adafactor" \
                else TRAIN_RTOL
            assert abs(a["grad_norm"] - b["grad_norm"]) <= \
                rtol * abs(b["grad_norm"])
            assert a["tokens"] == b["tokens"]


def test_int8_training_resumes_bitwise(world, tmp_path):
    """The int8 error-feedback residuals are part of the training state:
    2 steps, a checkpoint, and a fresh ``train_loop`` resumed to step 3
    equal 3 unbroken steps bitwise (the last step's metrics and every leaf
    of the final checkpoint, the residuals (one row per data rank)
    included)."""
    jc = jsmoke(jget("qwen1.5-0.5b"))
    out = world.run(cases.train_2x2_resume, "qwen1.5-0.5b",
                    _np(jrun_params(jc)), SMALL_SHAPE,
                    dict(lr=1e-3, warmup_steps=1, total_steps=3),
                    str(tmp_path))
    for r in out:
        a, b = r["unbroken"], r["resumed"]
        assert a["last"] == b["last"] and a["last"]["step"] == 2
        assert a["ckpt"].keys() == b["ckpt"].keys()
        assert all(np.array_equal(a["ckpt"][k], b["ckpt"][k])
                   for k in a["ckpt"])
        res = [k for k in a["ckpt"] if k.startswith("residuals/")]
        assert res and all(a["ckpt"][k].shape[0] == 2 for k in res)
        assert any(np.abs(a["ckpt"][k]).max() > 0 for k in res)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_expert_parallel_training_gradients_match_meshless(world, shape):
    """kimi-k2's expert banks split over the data axes (EP): the owner's
    gradient is the sum of every data rank's through the all-to-all, and
    the step divides it by the data size (an average over the data axes
    would mix different experts).  Every leaf's gradient within TRAIN_RTOL
    of max|g| of the meshless step's (measured <= 1.1e-6)."""
    gap, leaf = world.run(cases.ep_train_grads, "kimi-k2-1t-a32b", shape)[0]
    assert gap <= TRAIN_RTOL, leaf


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plan", [False, True])
def test_1x2_equals_the_meshless_model_in_tp_order(world2, plan, dtype):
    """The control of ``chip_smoke.py``'s 1 x 2 gate on the card: the
    meshless model whose row-parallel products outside the TD-VMM sites sum
    two float32 partial products in rank order (``chip_smoke.tp_order``)
    gives the 1 x 2 run's teacher-forced logits and engine streams bit for
    bit, TD-VMM off and under ffn_unchained, where the plain meshless
    float32 run is a rounding away (measured 6.8e-7 of max|logit|)."""
    out = world2.run(cases.tp_order_1x2, plan, dtype)
    assert all(r["logits"] and r["streams"] for r in out)
    assert out[0]["gap"] <= LOGIT_RTOL
    if dtype == "float32":
        assert out[0]["gap"] > 0        # the control is not the meshless run


def jrun_params(jc):
    """The JAX train_loop's initial weights (``init_train_state``'s key)."""
    return jmodel.init_params(jax.random.PRNGKey(0), jc)


# --------------------------------------------------------------------------
# In-process: placements, compression against the JAX functions, repairs
# --------------------------------------------------------------------------
def test_int8_quant_roundtrip_error_bounded():
    for seed in range(10):
        x = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (1000,)),
                       np.float32)
        codes, scale = tcomp._quantize_int8(torch.from_numpy(x))
        jcodes, jscale = jcomp._quantize_int8(jnp.asarray(x))
        assert np.array_equal(codes.numpy(), np.asarray(jcodes))
        assert np.array_equal(scale.numpy(), np.asarray(jscale))
        deq = tcomp._dequantize_int8(codes, scale, x.shape, x.size)
        assert np.array_equal(deq.numpy(), np.asarray(jcomp._dequantize_int8(
            jcodes, jscale, x.shape, x.size)))
        assert float(np.max(np.abs(deq.numpy() - x))) <= \
            float(np.max(np.abs(x))) / 127.0 + 1e-6


def test_error_feedback_reduces_bias():
    g = torch.from_numpy(np.asarray(
        jax.random.normal(jax.random.PRNGKey(0), (512,)), np.float32)) * 1e-3
    total_plain, total_ef = torch.zeros_like(g), torch.zeros_like(g)
    residual = torch.zeros_like(g)
    for _ in range(50):
        codes, scale = tcomp._quantize_int8(g)
        total_plain += tcomp._dequantize_int8(codes, scale, g.shape, g.numel())
        codes, scale = tcomp._quantize_int8(g + residual)
        deq = tcomp._dequantize_int8(codes, scale, g.shape, g.numel())
        residual = (g + residual) - deq
        total_ef += deq
    err_plain = float(torch.linalg.norm(total_plain / 50 - g))
    err_ef = float(torch.linalg.norm(total_ef / 50 - g))
    assert err_ef <= err_plain


def test_wire_bytes_saved_matches_jax():
    grads = {"w": torch.zeros((4096, 128)), "b": torch.zeros(300)}
    want = jcomp.wire_bytes_saved({"w": jnp.zeros((4096, 128)),
                                   "b": jnp.zeros(300)})
    assert tcomp.wire_bytes_saved(grads) == pytest.approx(float(want))
    assert tcomp.wire_bytes_saved(grads) > 0


class _FakeMesh:
    """Enough of a DeviceMesh for the placement rules (no process group)."""

    def __init__(self, shape, names):
        self._shape, self.mesh_dim_names = shape, names

    def size(self, dim=None):
        return int(np.prod(self._shape)) if dim is None else self._shape[dim]


def test_param_and_opt_specs_follow_the_jax_rules():
    from repro.launch import sharding as jshard

    from repro_torch.models import model as tmodel
    for arch in ("mixtral-8x7b", "kimi-k2-1t-a32b", "yi-34b"):
        tc = tsmoke(tget(arch))
        params = tmodel.init_params(0, tc, device="cpu")
        mesh = _FakeMesh((2, 2), ("data", "model"))
        specs = sharding.param_specs(params, tc, mesh)
        jc = jsmoke(jget(arch))
        jmesh = type("M", (), {"axis_names": ("data", "model"),
                               "shape": {"data": 2, "model": 2}})()
        jp = jax.eval_shape(lambda: jmodel.init_params(
            jax.random.PRNGKey(0), jc))
        jspecs = jshard.param_specs(jp, jc, jmesh)
        # the port keeps one dict per layer, the JAX package a stacked
        # leading layer dim: compare each rule by its trailing entries
        jflat = {jshard._path_str(p): tuple(s) for p, s in
                 jax.tree_util.tree_flatten_with_path(
                     jspecs, is_leaf=lambda x: isinstance(
                         x, jax.sharding.PartitionSpec))[0]}
        from repro_torch.tree import leaves_with_paths
        for path, spec in leaves_with_paths(specs):
            jpath = "/".join(p for p in path.split("/") if not p.isdigit())
            want = jflat[jpath]
            # a PartitionSpec writes a one-axis tuple as the bare name
            one = tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                        for a in spec)
            assert one == tuple(want[len(want) - len(spec):]), (path, spec,
                                                                  want)
        opt = make_optimizer(TOpt(name="adafactor")).init(params)
        ospecs = sharding.opt_state_specs(opt, specs)
        w = "blocks/seg0/0/attn/wq/w"
        flat = dict(leaves_with_paths(ospecs))
        base = dict(leaves_with_paths(specs))[w]
        assert tuple(flat[f"inner/{w}/vr"]) == tuple(base)[:-1]
        assert tuple(flat[f"inner/{w}/vc"]) == tuple(base)[-1:]



def test_parse_mesh_and_axis_info():
    assert meshlib.parse_mesh("none") is None and meshlib.parse_mesh("") is None
    with pytest.raises(ValueError, match="DxT"):
        meshlib.parse_mesh("2by2")
    with pytest.raises(ValueError, match="ranks"):
        meshlib.parse_mesh("2x2")          # a world of one
    assert meshlib.axis_info(_FakeMesh((2, 2, 2), meshlib.AXES_3D)) == {
        "dp_axes": ("pod", "data"), "tp_axis": "model"}


@pytest.mark.parametrize("arch,batch", [("qwen1.5-0.5b", 4),
                                        ("qwen1.5-0.5b", 3),
                                        ("mamba2-1.3b", 4)])
def test_batch_cache_paged_and_slot_specs_follow_the_jax_rules(arch, batch):
    from repro.launch import sharding as jshard
    from repro_torch.models import model as tmodel
    from repro_torch.tree import leaves_with_paths
    jc, tc = jsmoke(jget(arch)), tsmoke(tget(arch))
    mesh = _FakeMesh((2, 2), ("data", "model"))
    jmesh = type("M", (), {"axis_names": ("data", "model"),
                           "shape": {"data": 2, "model": 2}})()

    def norm(spec):
        return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                     for a in spec)

    def jflat(tree):
        return {jshard._path_str(p): norm(s) for p, s in
                jax.tree_util.tree_flatten_with_path(
                    tree, is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec))[0]}
    for kind in ("train", "prefill"):
        got = sharding.batch_specs(tc, mesh, kind, batch)
        want = jshard.batch_specs(jc, jmesh, kind, batch)
        assert {k: norm(v) for k, v in got.items()} == \
            {k: norm(v) for k, v in want.items()}
    for kind in ("prefill", "decode"):
        got = sharding.slot_specs(mesh, kind)
        want = jshard.slot_specs(jmesh, kind)
        assert {k: norm(v) for k, v in got.items()} == \
            {k: norm(v) for k, v in want.items()}
    caches = tmodel.init_caches(tc, batch, 24, "meta")
    want = jflat(jshard.cache_specs(jax.eval_shape(
        lambda: jmodel.init_caches(jc, batch, 24)), jc, jmesh))
    got = {p: norm(s) for p, s in leaves_with_paths(
        sharding.cache_specs(caches, tc, mesh))}
    assert got == want
    if jc.family == "dense":
        pools = tmodel.init_paged_caches(tc, 8, 4, "meta")
        want = jflat(jshard.paged_specs(jax.eval_shape(
            lambda: jmodel.init_paged_caches(jc, 8, 4)), jc, jmesh))
        got = {p: norm(s) for p, s in leaves_with_paths(
            sharding.paged_specs(pools, tc, mesh))}
        assert got == want
