"""The MoE slice of the port against the JAX package (its ``backend="jnp"``
expert path, which its own contract holds bitwise to its kernels):
``td_expert_matmul`` and its recorded (E,) windows bitwise under the
int8 (p = 6), f32-code (8 x 4 bits) and int4 (3 x 3 bits) precisions; the
sort-based dispatch and its capacity drops exactly; the router and
``moe.apply`` within float32 tolerance; the sliding-window cache's mask and
ring."""
import dataclasses

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
from repro.core import calibration as jcal
from repro.core import layers as jlayers
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro_torch.configs import TDVMMLayerConfig as TLayer
from repro_torch.configs import TDVMMPlan as TPlan
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke as tsmoke
from repro_torch.configs import tdvmm_rule as trule
from repro_torch.core import calibration as tcal
from repro_torch.core import layers as tlayers
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.runtime.engine import Engine, EngineConfig

# moe.apply against the reference, max|diff| over max|y|: the router
# logits, softmax, the expert FFN's float32 products and the gate
# combination sum in other orders on the two sides (the TD-VMM codes are
# bitwise); measured <= 2.7e-7 on the CPU (four seeds, both archs, every
# plan).  A routing flip or a moved code (one readout level) fails it.
MOE_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


# the two plans' precisions: moe_unchained (p = 6, int8 codes), moe_mixed's
# moe.expert.in (8-bit inputs x 4-bit weights, f32 codes) and
# moe.expert.out (3 x 3 bits, int4 pairs)
PRECISIONS = {
    "p6_int8": dict(bits=6, weight_bits=6),
    "p8x4_f32": dict(bits=8, weight_bits=4),
    "p3x3_int4": dict(bits=3, weight_bits=3),
}
CODE_DTYPES = {"p6_int8": "int8", "p8x4_f32": "f32", "p3x3_int4": "int4"}


def _bank(e, c, k, n, seed=0, zero_rows=3):
    """(x (E, C, K), w (E, K, N)): the last ``zero_rows`` rows of every
    expert are capacity padding, and expert 1 received no token."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, c, k)).astype(np.float32)
    x[:, c - zero_rows:] = 0.0
    x[1] = 0.0
    w = (rng.standard_normal((e, k, n)) * k ** -0.5).astype(np.float32)
    return x, w


def _expert_pair(kw, x, w, backend="auto", j_kw=None):
    """(port output, reference output) of td_expert_matmul."""
    yj = jlayers.td_expert_matmul(
        jnp.asarray(x), jnp.asarray(w),
        JLayer(backend="jnp", site="moe.expert.in", **(j_kw or kw)))
    yt = tlayers.td_expert_matmul(
        torch.from_numpy(x), torch.from_numpy(w),
        TLayer(backend=backend, site="moe.expert.in", **kw))
    return yt.numpy(), np.asarray(yj)


@pytest.mark.parametrize("readout", ["data", "pinned", "runtime",
                                     "no_readout"])
@pytest.mark.parametrize("prec", sorted(PRECISIONS))
def test_td_expert_matmul_bitwise(prec, readout):
    kw = dict(PRECISIONS[prec], enabled=True)
    k = 33 if prec == "p3x3_int4" else 64           # an odd K packs a pad
    x, w = _bank(4, 9, k, 48, seed=len(prec))
    e = x.shape[0]
    assert tlayers._plan_code_dtype(TLayer(**kw), k, False) == \
        CODE_DTYPES[prec]
    if readout == "no_readout":
        kw["io_quantize"] = False
    windows = None
    if readout in ("pinned", "runtime"):
        with tcal.collect() as got:
            tlayers.td_expert_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                     TLayer(site="moe.expert.in", **kw))
        windows = np.maximum(got["moe.expert.in"], np.float32(1e-9)) * \
            np.float32(0.8)
    if readout == "pinned":
        kw["out_scale"] = tuple(float(v) for v in windows)
    for backend in ("auto", "jnp"):
        if readout == "runtime":
            with tcal.runtime_windows(
                    {"moe.expert.in": torch.from_numpy(windows)}):
                yt, yj = _expert_pair(kw, x, w, backend, j_kw=dict(
                    kw, out_scale=tuple(float(v) for v in windows)))
        else:
            yt, yj = _expert_pair(kw, x, w, backend)
        assert yt.shape == yj.shape == (e, 9, 48)
        np.testing.assert_array_equal(yt, yj, err_msg=f"backend={backend}")
    # capacity padding and an empty expert integrate nothing
    assert not np.any(yt[:, -3:]) and not np.any(yt[1])


@pytest.mark.parametrize("prec", sorted(PRECISIONS))
def test_td_expert_matmul_records_expert_windows(prec):
    kw = dict(PRECISIONS[prec], enabled=True, site="moe.expert.out")
    x, w = _bank(4, 7, 32, 40, seed=5, zero_rows=2)
    with jcal.collect() as got_j:
        jlayers.td_expert_matmul(jnp.asarray(x), jnp.asarray(w),
                                 JLayer(backend="jnp", **kw))
    with tcal.collect() as got_t:
        tlayers.td_expert_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                 TLayer(**kw))
    assert got_t.keys() == got_j.keys() == {"moe.expert.out"}
    np.testing.assert_array_equal(got_t["moe.expert.out"],
                                  np.asarray(got_j["moe.expert.out"]))
    assert got_t["moe.expert.out"].shape == (4,)
    assert got_t["moe.expert.out"][1] == 0.0           # the empty expert
    # applied, both pin the same (E,) tuple
    cal_t = tcal.CalibrationState.from_collected(got_t)
    cfg = tsmoke(tget("mixtral-8x7b")).replace(
        tdvmm_plan=TPlan((trule("moe.*", enabled=True),)))
    pinned = tcal.apply_calibration(cfg, cal_t).site_tdvmm("moe.expert.out")
    assert pinned.out_scale == tuple(
        float(v) for v in np.maximum(got_j["moe.expert.out"],
                                     np.float32(1e-9)))


def test_td_expert_matmul_empty_capacity_and_refusals():
    cfg = TLayer(enabled=True, site="moe.expert.in")
    y = tlayers.td_expert_matmul(torch.zeros((3, 0, 16)),
                                 torch.ones((3, 16, 8)), cfg)
    assert tuple(y.shape) == (3, 0, 8)
    with pytest.raises(ValueError, match="shapes"):
        tlayers.td_expert_matmul(torch.zeros((3, 2, 16)),
                                 torch.ones((2, 16, 8)), cfg)
    # programming noise is no refusal any more: the codes go float32
    y = tlayers.td_expert_matmul(torch.zeros((3, 2, 16)),
                                 torch.ones((3, 16, 8)),
                                 cfg.replace(noise=True), key=0)
    assert tuple(y.shape) == (3, 2, 8) and bool(torch.isfinite(y).all())


# ---------------------------------------------------------------------------
# Routing and dispatch
# ---------------------------------------------------------------------------
def _ids(t, k, e, seed):
    """Top-k style expert ids: k distinct experts per token."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(
        np.int32)


@pytest.mark.parametrize("factor", [0.01, 1.25])
def test_dispatch_and_capacity_drops_match_reference(factor):
    t, k, e, d = 37, 2, 4, 6
    ids = _ids(t, k, e, seed=int(factor * 100))
    cap = tmoe._capacity(t, k, e, factor)
    assert cap == jmoe._capacity(t, k, e, factor)
    got = tmoe._dispatch_indices(torch.from_numpy(ids).long(), k)
    want = jmoe._dispatch_indices(jnp.asarray(ids), k)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    se, pos, order, tok = got
    dropped = int((pos >= cap).sum())
    assert dropped == (t * k - sum(min(int((ids == i).sum()), cap)
                                   for i in range(e)))
    assert (dropped > 0) == (factor < 1)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((t, d)).astype(np.float32)
    buf_t = tmoe._scatter_to_buffer(torch.from_numpy(x), se, pos, tok, e, cap)
    buf_j = jmoe._scatter_to_buffer(jnp.asarray(x), *map(jnp.asarray, (
        se.numpy(), pos.numpy(), tok.numpy())), e, cap)
    np.testing.assert_array_equal(buf_t.numpy(), np.asarray(buf_j))
    gates = rng.uniform(0, 1, (t, k)).astype(np.float32)
    out = rng.standard_normal((e, cap, d)).astype(np.float32)
    y_t = tmoe._gather_from_buffer(torch.from_numpy(out), se, pos, order,
                                   torch.from_numpy(gates), k)
    y_j = jmoe._gather_from_buffer(jnp.asarray(out), *map(jnp.asarray, (
        se.numpy(), pos.numpy(), order.numpy(), gates)), k)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))


def _moe_params(arch, seed=0):
    jc = jsmoke(jget(arch))
    jp = jmoe.init(jax.random.PRNGKey(seed), jc, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), jp)
    return jc, tsmoke(tget(arch)), jp, tp


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def test_route_matches_reference():
    jc, tc, jp, tp = _moe_params("kimi-k2-1t-a32b", seed=2)
    x = np.random.default_rng(4).standard_normal((29, jc.d_model)).astype(
        np.float32)
    ids_t, gates_t, aux_t = tmoe._route(tp, torch.from_numpy(x), tc)
    ids_j, gates_j, aux_j = jmoe._route(jp, jnp.asarray(x), jc)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    assert _rel(gates_t.numpy(), gates_j) <= 1e-6
    for name in ("lb_loss", "z_loss"):
        assert abs(float(aux_t[name]) - float(aux_j[name])) <= \
            1e-6 * abs(float(aux_j[name]))
    # equal probabilities order as jax.lax.top_k does: lower index first
    tied = torch.zeros((1, jc.d_model))
    ids_t, gates_t, _ = tmoe._route(tp, tied, tc)
    ids_j, _, _ = jmoe._route(jp, jnp.zeros((1, jc.d_model)), jc)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    assert ids_t.tolist() == [list(range(tc.moe.top_k))]


MOE_PLANS = {
    "off": (),
    "moe_unchained": (("moe.*", dict(enabled=True)),),
    "moe_mixed": (("moe.*", dict(enabled=True)),
                  ("moe.expert.in", dict(bits=8, weight_bits=4)),
                  ("moe.expert.out", dict(bits=3, weight_bits=3))),
}


def plan_pair(name):
    """(reference plan with backend="jnp", port plan) for ``name``."""
    rules = MOE_PLANS[name]
    return (JPlan(tuple(jrule(p, backend="jnp", **kw) if "enabled" in kw
                        else jrule(p, **kw) for p, kw in rules)),
            TPlan(tuple(trule(p, **kw) for p, kw in rules)))


@pytest.mark.parametrize("plan", sorted(MOE_PLANS))
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "kimi-k2-1t-a32b"])
def test_moe_apply_matches_reference(arch, plan):
    """Routed experts alone (mixtral) and with a shared expert (kimi-k2)."""
    jc, tc, jp, tp = _moe_params(arch)
    jplan, tplan = plan_pair(plan)
    jc, tc = jc.replace(tdvmm_plan=jplan), tc.replace(tdvmm_plan=tplan)
    assert bool(tc.moe.n_shared_experts) == (arch != "mixtral-8x7b")
    x = np.random.default_rng(6).standard_normal((2, 11, jc.d_model)).astype(
        np.float32)
    y_t, aux_t = tmoe.apply(tp, torch.from_numpy(x), tc)
    y_j, aux_j = jmoe.apply(jp, jnp.asarray(x), jc)
    assert tuple(y_t.shape) == x.shape
    assert _rel(y_t.numpy(), y_j) <= MOE_RTOL
    for name in ("lb_loss", "z_loss"):
        assert abs(float(aux_t[name]) - float(aux_j[name])) <= \
            1e-6 * abs(float(aux_j[name]))


def test_moe_apply_refuses_a_mesh():
    """Expert parallelism refuses a mesh whose data axis does not divide
    the expert count, before any collective (the mesh paths themselves are
    held on gloo worlds in tests/test_torch_dist_mesh.py)."""
    from repro_torch.launch import meshctx

    class ThreeDataRanks:
        mesh_dim_names = ("data", "model")

        def size(self, dim=None):
            return 3 if dim is None else (3, 1)[dim]

        def get_local_rank(self, axis):
            return 0

    _, tc, _, tp = _moe_params("kimi-k2-1t-a32b")
    assert tc.moe.impl == "ep" and tc.moe.n_experts % 3
    with meshctx.use_mesh(ThreeDataRanks(), ("data",), "model"):
        with pytest.raises(ValueError, match="do not split over 3"):
            tmoe.apply(tp, torch.zeros((3, 3, tc.d_model)), tc)


# ---------------------------------------------------------------------------
# Sliding-window attention in the dense cache
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [None, 1, 3, 8])
@pytest.mark.parametrize("offset", [0, 5])
def test_causal_mask_matches_reference(window, offset):
    got = tattn._causal_mask(6, 11, offset, window, "cpu")
    want = jattn._causal_mask(6, 11, offset, window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sliding_window_cache_and_refusals():
    tc = tsmoke(tget("mixtral-8x7b"))
    assert tc.swa_window == 8
    caches = tmodel.init_caches(tc, 2, 30, "cpu")
    assert tuple(caches["seg0"].k.shape) == (2, 2, 8, tc.n_kv_heads, 16)
    short = tmodel.init_caches(tc, 2, 5, "cpu")          # min(max_len, window)
    assert tuple(short["seg0"].k.shape)[2] == 5
    with pytest.raises(NotImplementedError, match="sliding-window"):
        tattn.init_paged_cache(tc, 8, 4, torch.float32, "cpu")
    with pytest.raises(NotImplementedError, match="sliding-window"):
        tmodel.init_paged_caches(tc, 8, 4, "cpu")
    params = tmodel.init_params(0, tc, device="cpu")
    assert params["blocks"]["seg0"][0]["moe"]["router"]["w"].dtype == \
        torch.float32
    with pytest.raises(NotImplementedError, match="sliding-window"):
        Engine(tc, params, EngineConfig(), device="cpu")


def test_first_k_dense_segments():
    tc = tsmoke(tget("mixtral-8x7b"))
    tc = tc.replace(moe=dataclasses.replace(tc.moe, first_k_dense=1))
    from repro_torch.models import transformer
    assert transformer.segments(tc) == [("attn_ffn", 1), ("attn_moe", 1)]
    params = tmodel.init_params(0, tc, device="cpu")
    assert "ffn" in params["blocks"]["seg0"][0]
    assert "moe" in params["blocks"]["seg1"][0]
