"""The port's public surface against the JAX package's, and the last names
ported held to the JAX package's on the CPU.

The surface walk reads every module of ``src/repro/`` with ``ast`` and
lists its public names: top-level functions, classes and constants, the
names of a module's ``__all__``, and each public class's methods and
fields.  Each must have a counterpart in the module of the same path in
``repro_torch`` (``hasattr``, so a re-export counts), or an entry in one of
the two tables below: ``RENAMED`` (the port's name for it, in the same
module unless the entry names another) or ``NOT_PORTED`` (why the port has
none).  A table entry is consulted first, and each entry must still name a
public name of the JAX package.  Underscore names are out of scope.

Then ``TDVMMLinear`` (``from_params`` on the JAX package's weights, bias,
chained and pinned configs, ``calibrate``), ``init_linear``,
``llm_mapping_cost``, ``QuantizedTensor.dequantize``,
``FaultInjector.report`` and ``crossing_times_exact`` against the JAX
package's, and the engine's drift check against the JAX engine's."""
import ast
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TDVMMLayerConfig as JLayer
from repro.configs import get_config as jget
from repro.configs import plan as jplan
from repro.core import energy as jenergy
from repro.core import layers as jlayers
from repro.core import quant as jquant
from repro.kernels.crossing import ops as jcross
from repro.runtime import engine as jengine
from repro.runtime import faultinject as jfi
from repro_torch.configs import TDVMMLayerConfig as TLayer
from repro_torch.configs import get_config as tget
from repro_torch.configs import plan as tplan
from repro_torch.core import energy as tenergy
from repro_torch.core import layers as tlayers
from repro_torch.core import quant as tquant
from repro_torch.kernels.crossing import ops as tcross
from repro_torch.kernels.crossing import ref as tref
from repro_torch.runtime import faultinject as tfi
from repro_torch.runtime.engine import (DriftConfig, Engine, EngineConfig,
                                        FaultConfig, Request)
from test_torch_fault import ECFG, _drifted, _same_streams, _served, _trace

# JAX name -> the port's name: "name" in the same module, or
# "module:name" in another.
RENAMED = {
    "repro.core.layers:MatmulPlan.blocks": "MatmulPlan.tile",
    "repro.core.layers:TDVMMLinear.init": "TDVMMLinear.__init__",
    "repro.core.layers:TDVMMLinear.apply": "TDVMMLinear.forward",
    # the port's simulator functions take (..., N_in) inputs: no vmap
    "repro.core.tdcore:td_vmm_four_quadrant_batched": "td_vmm_four_quadrant",
    "repro.core.tdcore:td_mlp_forward_batched": "td_mlp_forward",
    "repro.kernels.crossing.ref:crossing_ref": "crossing_exact",
    "repro.kernels.ssd.ssd:ssd_kernel": "ssd_scan",
    "repro.models.ssm:ssd_chunked": "repro_torch.kernels.ssd.ssd:ssd_plain",
    "repro.kernels.tdvmm.autotune_table:MOSAIC_TABLE": "HOPPER_TABLE",
    "repro.kernels.tdvmm.tdvmm:AUTOTUNE_TABLE": "autotune_table",
    "repro.kernels.tdvmm.tdvmm:tdvmm_matmul_kernel": "tdvmm_matmul_raw",
    "repro.kernels.tdvmm.tdvmm:tdvmm_fused_kernel": "tdvmm_fused",
    "repro.kernels.tdvmm.tdvmm:tdvmm_calibrated_kernel": "tdvmm_calibrated",
    # the CTA tile takes the place of the three Pallas block sizes
    "repro.kernels.tdvmm.ops:KernelPlan.bm": "KernelPlan.tile",
    "repro.kernels.tdvmm.ops:KernelPlan.bk": "KernelPlan.tile",
    "repro.kernels.tdvmm.ops:KernelPlan.bn": "KernelPlan.tile",
    "repro.kernels.tdvmm.ops:KernelPlan.blocks": "KernelPlan.tile",
    "repro.launch.pipeline:stage_split_params": "stage_layers",
    "repro.launch.serve:serve": "serve_static",
    "repro.optim.compression:compressed_psum": "compressed_all_reduce",
    "repro.optim.compression:compressed_tree_psum":
        "compressed_tree_all_reduce",
    "repro.runtime.engine:EngineReport.compiled_steps":
        "EngineReport.step_shapes",
    "repro.runtime.engine:Engine.compiled_steps": "EngineReport.step_shapes",
}

# JAX name or module -> why the port has no counterpart
_TPU_PEAK = ("a TPU v5e data-sheet peak; the port prices an H100 "
             "(core/constants.py H100_*)")
_HLO = ("parses XLA's HLO text; the port counts a step on fake tensors "
        "(launch/roofline.StepCounter)")
_UNREAD = "read by nothing in the JAX package: the option has no effect there"
_TESTS_ONLY = "set only by the JAX package's tests"
_BLOCKS = ("the Pallas kernel's default MXU block; the CUDA kernels take a "
           "CTA tile (kernels/tdvmm/tdvmm.TILES)")
_OUT_DTYPE = ("a bfloat16 torch matmul returns bfloat16 already: the dry "
              "run's opt level 1 needs no setter (launch/dryrun.py)")
NOT_PORTED = {
    "repro.launch.compat": "a JAX shard_map / CompilerParams shim",
    "repro.core.constants:TPU_PEAK_FLOPS_BF16": _TPU_PEAK,
    "repro.core.constants:TPU_HBM_BW": _TPU_PEAK,
    "repro.core.constants:TPU_ICI_BW": _TPU_PEAK,
    "repro.core.nonideal:NonIdealityConfig.latch_mismatch": _UNREAD,
    "repro.core.nonideal:NonIdealityConfig.seed_salt": _UNREAD,
    "repro.runtime.sla:SlaConfig.admission_deadline": _TESTS_ONLY,
    "repro.runtime.sla:SlaConfig.admission_energy": _TESTS_ONLY,
    "repro.runtime.engine:DriftConfig.max_len": _TESTS_ONLY,
    "repro.runtime.engine:DriftConfig.recalibrate": _TESTS_ONLY,
    "repro.kernels:tpu_compiler_params": "Pallas's TPU compiler parameters",
    "repro.kernels.tdvmm.autotune_table:INTERPRET_TABLE":
        "Pallas interpret mode's block table; the plain versions take no "
        "tile, and HOPPER_TABLE answers on both devices",
    "repro.kernels.tdvmm.tdvmm:BM": _BLOCKS,
    "repro.kernels.tdvmm.tdvmm:BK": _BLOCKS,
    "repro.kernels.tdvmm.tdvmm:BN": _BLOCKS,
    "repro.kernels.tdvmm.tdvmm:min_sublane": "Mosaic's sublane minimum",
    "repro.kernels.tdvmm.tdvmm:pad_to_blocks":
        "pads codes to whole Pallas blocks; the CUDA kernels take unpadded "
        "operands and guard their tile edges",
    "repro.launch.roofline:HLOStats": _HLO,
    "repro.launch.roofline:HLOStats.flops": _HLO,
    "repro.launch.roofline:HLOStats.hbm_bytes": _HLO,
    "repro.launch.roofline:HLOStats.coll": _HLO,
    "repro.launch.roofline:HLOStats.coll_total": _HLO,
    "repro.launch.roofline:analyze_hlo": _HLO,
    "repro.launch.roofline:collective_bytes_per_device": _HLO,
    "repro.launch.roofline:RooflineTerms.ici_links":
        "the TPU's ICI link count; the port prices collectives by link "
        "class (RooflineTerms.coll_bytes_by_link)",
    "repro.launch.sharding:to_named": "builds jax.sharding.NamedSharding",
    "repro.launch.sharding:sds_with_sharding":
        "builds jax.ShapeDtypeStruct stand-ins",
    "repro.models.common:set_matmul_out_dtype": _OUT_DTYPE,
    "repro.models.common:matmul_out_dtype": _OUT_DTYPE,
}

# the names this port's last slice added, found under their own names
OWN_NAMES = ("repro.core.layers:TDVMMLinear", "repro.core.layers:init_linear",
             "repro.core:TDVMMLinear", "repro.core:td_matmul",
             "repro.core:TDVMMLayerConfig",
             "repro.core.energy:llm_mapping_cost",
             "repro.core.quant:QuantizedTensor.dequantize",
             "repro.runtime.faultinject:FaultInjector.report",
             "repro.kernels.crossing.ops:crossing_times_exact")

JAX_SRC = Path(__file__).resolve().parents[1] / "src" / "repro"


def _module_name(path: Path) -> str:
    parts = path.relative_to(JAX_SRC.parent).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


JAX_MODULES = {_module_name(p): p for p in sorted(JAX_SRC.rglob("*.py"))}


def _top(body):
    for node in body:
        if isinstance(node, (ast.If, ast.Try)):
            yield from _top(node.body)
            yield from _top(node.orelse)
            for h in getattr(node, "handlers", ()):
                yield from _top(h.body)
        else:
            yield node


def _targets(node):
    if isinstance(node, ast.Assign):
        for t in node.targets:
            for e in (t.elts if isinstance(t, ast.Tuple) else (t,)):
                if isinstance(e, ast.Name):
                    yield e.id
    elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                        ast.Name):
        yield node.target.id


def public_names(path: Path) -> list[str]:
    """The module's public names; a class member as "Class.member"."""
    out = []
    for node in _top(ast.parse(path.read_text()).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(node.name)
        elif isinstance(node, ast.ClassDef):
            out.append(node.name)
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.append(f"{node.name}.{m.name}")
                else:
                    out += [f"{node.name}.{t}" for t in _targets(m)]
        else:
            names = list(_targets(node))
            if names == ["__all__"] and isinstance(node.value, ast.List):
                out += [e.value for e in node.value.elts]
            out += names
    return sorted({n for n in out
                   if not any(p.startswith("_") for p in n.split("."))})


def _has(obj, dotted: str) -> bool:
    """``hasattr`` along a dotted path; a class's dataclass or NamedTuple
    field counts without a default."""
    for part in dotted.split("."):
        if hasattr(obj, part):
            obj = getattr(obj, part)
            continue
        return isinstance(obj, type) and any(
            part in getattr(c, "__annotations__", {}) for c in obj.__mro__)
    return True


def _port(module: str) -> str:
    return "repro_torch" + module[len("repro"):]


def _target(module: str, name: str):
    """(port module, name) of a RENAMED entry's value."""
    mod, _, attr = name.rpartition(":")
    return importlib.import_module(mod or _port(module)), attr


@pytest.mark.parametrize("module", sorted(JAX_MODULES))
def test_every_public_name_has_a_counterpart(module):
    if module in NOT_PORTED:
        assert importlib.util.find_spec(_port(module)) is None
        return
    port = importlib.import_module(_port(module))
    missing = []
    for name in public_names(JAX_MODULES[module]):
        key = f"{module}:{name}"
        if key in NOT_PORTED:
            continue
        if key in RENAMED:
            ok = _has(*_target(module, RENAMED[key]))
        else:
            ok = _has(port, name)
        if not ok:
            missing.append(key)
    assert not missing, missing


def test_no_table_entry_is_stale():
    names = {f"{m}:{n}" for m, p in JAX_MODULES.items()
             for n in public_names(p)}
    for key in list(RENAMED) + list(NOT_PORTED):
        assert key in names or (":" not in key and key in JAX_MODULES), key
        assert NOT_PORTED.get(key, "x") and RENAMED.get(key, "x")
    assert not set(RENAMED) & set(NOT_PORTED)


@pytest.mark.parametrize("key", OWN_NAMES)
def test_last_slice_names_are_found_under_their_own_names(key):
    module, name = key.split(":")
    assert key not in RENAMED and key not in NOT_PORTED
    assert name in public_names(JAX_MODULES[module])
    assert _has(importlib.import_module(_port(module)), name)


# ---------------------------------------------------------------------------
# TDVMMLinear, init_linear
# ---------------------------------------------------------------------------
@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


LINEAR_CFGS = {
    "data_calibrated": dict(enabled=True),
    "pinned": dict(enabled=True, out_scale=0.05),
    "chained": dict(enabled=True, io_quantize=False),       # no readout
}


def _linear(bias: bool, dtype: str, d_in=130, d_out=96, seed=0):
    """(JAX params, the same as numpy, x as numpy float32)."""
    rng = np.random.default_rng(seed)
    jd = getattr(jnp, dtype)
    p = jlayers.TDVMMLinear.init(jax.random.PRNGKey(seed), d_in, d_out,
                                 bias=bias, dtype=jd)
    if bias:     # a nonzero bias, so that adding it is checked
        p["b"] = jnp.asarray(rng.standard_normal(d_out) * 0.1).astype(jd)
    x = rng.standard_normal((2, 5, d_in)).astype(np.float32)
    return p, jax.tree.map(np.asarray, p), x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("site", sorted(LINEAR_CFGS))
def test_tdvmm_linear_matches_reference(site, bias, dtype):
    """``TDVMMLinear.from_params`` on the JAX package's parameters gives
    its ``TDVMMLinear.apply`` bit for bit, in float32 and in bfloat16, with
    the parameters needing a gradient (QAT) or not."""
    kw = LINEAR_CFGS[site]
    p, pn, x = _linear(bias, dtype)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jlayers.TDVMMLinear.apply(p, jnp.asarray(x).astype(jd),
                                     JLayer(backend="jnp", **kw))
    want = np.asarray(want.astype(jnp.float32))
    layer = tlayers.TDVMMLinear.from_params(pn, TLayer(**kw), "cpu")
    assert layer.w.dtype == td and (layer.b is not None) == bias
    assert [n for n, _ in layer.named_parameters()] == (
        ["w", "b"] if bias else ["w"])
    xt = torch.from_numpy(x).to(td)
    with torch.no_grad():
        got = layer(xt)
    assert got.dtype == td
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(layer(xt).detach().float().numpy(), want)


def test_tdvmm_linear_calibrate_matches_reference():
    """``calibrate`` gives the JAX method's window exactly and leaves the
    layer unchanged; the pinned layer gives the JAX package's pinned
    output; on a noisy config with a key the window is
    ``calibrate_out_scale``'s on the same noisy codes."""
    p, pn, x = _linear(True, "float32")
    jcfg = JLayer(enabled=True, backend="jnp")
    layer = tlayers.TDVMMLinear.from_params(pn, TLayer(enabled=True), "cpu")
    xt = torch.from_numpy(x)
    pinned = layer.calibrate(xt)
    jpinned = jlayers.TDVMMLinear.calibrate(p, jnp.asarray(x), jcfg)
    assert pinned.out_scale == jpinned.out_scale
    assert layer.cfg.out_scale is None
    layer.cfg = pinned
    with torch.no_grad():
        got = layer(xt)
    want = jlayers.TDVMMLinear.apply(p, jnp.asarray(x), jpinned)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    noisy = TLayer(enabled=True, noise=True)
    layer = tlayers.TDVMMLinear.from_params(pn, noisy, "cpu")
    s = layer.calibrate(xt, key=3).out_scale
    assert s == tlayers.calibrate_out_scale(xt, layer.w, noisy, 3)
    assert s != pinned.out_scale          # the key perturbed the currents


def test_init_linear_draws():
    g = torch.Generator().manual_seed(5)
    w = tlayers.init_linear(g, 256, 512, dtype=torch.bfloat16)
    wj = jlayers.init_linear(jax.random.PRNGKey(5), 256, 512, jnp.bfloat16)
    assert tuple(w.shape) == wj.shape and str(w.dtype) == f"torch.{wj.dtype}"
    # 131,072 draws: the sample std's own spread is ~0.2 % of the scale
    for got in (float(w.float().std()),
                float(jnp.std(wj.astype(jnp.float32)))):
        assert abs(got * 256 ** 0.5 - 1.0) < 0.02
    again = tlayers.init_linear(torch.Generator().manual_seed(5), 256, 512,
                                dtype=torch.bfloat16)
    assert torch.equal(w, again)
    assert not torch.equal(w, tlayers.init_linear(
        torch.Generator().manual_seed(6), 256, 512, dtype=torch.bfloat16))
    w2 = tlayers.init_linear(torch.Generator().manual_seed(5), 256, 512,
                             scale=2.0)
    assert torch.equal(w2, (torch.randn((256, 512), generator=torch.Generator(
    ).manual_seed(5)) * 2.0))
    layer = tlayers.TDVMMLinear(256, 512, TLayer(enabled=True), bias=True,
                                generator=torch.Generator().manual_seed(5))
    assert torch.equal(layer.w.detach(), tlayers.init_linear(
        torch.Generator().manual_seed(5), 256, 512))
    assert torch.equal(layer.b.detach(), torch.zeros(512))


def test_core_reexports_the_layer_objects():
    import repro_torch.core as tcore
    assert tcore.TDVMMLinear is tlayers.TDVMMLinear
    assert tcore.td_matmul is tlayers.td_matmul
    assert tcore.TDVMMLayerConfig is TLayer
    assert sorted(tcore.__all__) == sorted(__import__(
        "repro.core", fromlist=["__all__"]).__all__)
    with pytest.raises(AttributeError):
        tcore.no_such_name


# ---------------------------------------------------------------------------
# llm_mapping_cost, dequantize, FaultInjector.report, crossing_times_exact
# ---------------------------------------------------------------------------
def _linear_shapes(site_shapes: dict) -> list[tuple[int, int]]:
    """Every weight matrix applied per token, from ``site_linear_shapes``."""
    return [tuple(m) for info in site_shapes.values()
            for _ in range(info["per_token"]) for m in info["matrices"]]


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("tile_n", [256, 1024])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mixtral-8x7b",
                                  "mamba2-1.3b"])
def test_llm_mapping_cost_equals_reference(arch, tile_n, bits):
    shapes = _linear_shapes(tplan.site_linear_shapes(tget(arch)))
    assert shapes == _linear_shapes(jplan.site_linear_shapes(jget(arch)))
    got = tenergy.llm_mapping_cost(shapes, tile_n=tile_n, bits=bits)
    assert got == jenergy.llm_mapping_cost(shapes, tile_n=tile_n, bits=bits)
    assert got["tiles"] > 0 and got["tops_per_j"] > 0


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_dequantize_bitwise(bits):
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((3, 7, 40)).astype(np.float32)
    w = (rng.standard_normal((40, 24)) * 0.2).astype(np.float32)
    pairs = [(tquant.encode_input(torch.from_numpy(x), bits),
              jquant.encode_input(jnp.asarray(x), bits))]
    for per_channel in (True, False):
        pairs.append((tquant.program_weights(torch.from_numpy(w), bits,
                                             per_channel),
                      jquant.program_weights(jnp.asarray(w), bits,
                                             per_channel)))
    for t, j in pairs:
        got = t.dequantize()
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(j.dequantize()))


def _schedule(mod):
    return mod.FaultInjector([
        mod.FailStep(step=2, kind="any", times=1),
        mod.SlowStep(step=3, sleep_s=0.001),
        mod.DriftAt(step=4, sigma=0.05, seed=1),
        mod.PreemptAt(step=10 ** 6)])


def test_fault_injector_report_equals_reference():
    """The same schedule through the JAX engine and the port's (the smoke
    qwen under ``ffn.*`` with the windows pinned, as in
    ``tests/test_torch_fault.py``): equal reports, fired events included."""
    jc, tc, jparams, tparams, jcal, tcal, _ = _served()
    trace = _trace(jc.vocab_size, n=6, seed=5)
    jinj, tinj = _schedule(jfi), _schedule(tfi)
    assert tinj.report() == jinj.report()
    jengine.Engine(jc, jparams, jengine.EngineConfig(**ECFG),
                   calib=jcal).run([jengine.Request(**r) for r in trace],
                                   jengine.FaultConfig(injector=jinj,
                                                       backoff_s=0.001))
    Engine(tc, tparams, EngineConfig(**ECFG), calib=tcal, device="cpu").run(
        [Request(**r) for r in trace],
        FaultConfig(injector=tinj, backoff_s=0.001))
    rep = tinj.report()
    assert rep == jinj.report()
    assert [r["event"] for r in rep] == ["FailStep", "SlowStep", "DriftAt",
                                        "PreemptAt"]
    assert [r["fired"] for r in rep] == [1, True, True, False]


# two sort-based solves in float32 with their cumulative sums in another
# order (XLA against torch): tests/test_torch_crossing.py's EXACT_ATOL
EXACT_ATOL = 1e-6


@pytest.mark.parametrize("b,k,n", [(4, 21, 20), (16, 64, 48)])
def test_crossing_times_exact_matches_reference(b, k, n):
    rng = np.random.default_rng(b * k + n)
    t_on = rng.uniform(0.0, 1.0, (b, k)).astype(np.float32)
    cur = rng.uniform(0.0, 1.0, (k, n)).astype(np.float32)
    charge = 0.3 * k * 0.5
    t, c = torch.from_numpy(t_on), torch.from_numpy(cur)
    got = tcross.crossing_times_exact(t, c, charge)
    assert torch.equal(got, tref.crossing_exact(t, c, charge))
    want = jcross.crossing_times_exact(jnp.asarray(t_on), jnp.asarray(cur),
                                       charge)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=EXACT_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# The drift check
# ---------------------------------------------------------------------------
def test_drift_check_equals_reference():
    """The JAX package's drifted weights served from the stale windows,
    its drift check every 4 steps: the port's drift events (clip rates,
    window ratios), recalibrations and streams equal the JAX engine's.
    The JAX event's ``recalibrated`` flag, always true under its default
    ``recalibrate``, has no counterpart (NOT_PORTED)."""
    jc, tc, jparams, _, jcal, tcal, tokens = _served()
    jd, td = _drifted(jc, tc, jparams)
    trace = _trace(jc.vocab_size, n=6, seed=5)
    kw = dict(check_every=4, clip_threshold=0.005, window_tol=0.05)
    jrep = jengine.Engine(jc, jd, jengine.EngineConfig(**ECFG),
                          calib=jcal).run(
        [jengine.Request(**r) for r in trace],
        jengine.FaultConfig(drift=jengine.DriftConfig(
            probe_batch={"inputs": jnp.asarray(tokens)}, **kw)))
    eng = Engine(tc, td, EngineConfig(**ECFG), calib=tcal, device="cpu")
    trep = eng.run([Request(**r) for r in trace], FaultConfig(
        drift=DriftConfig(probe_batch={"inputs": torch.from_numpy(tokens)},
                          **kw)))
    _same_streams(jrep, trep)
    assert all(e.pop("recalibrated") for e in jrep.drift_events)
    assert trep.drift_events == jrep.drift_events and trep.drift_events
    assert trep.recalibrations == jrep.recalibrations == len(
        trep.drift_events)


def test_acc_dtype_for_matches_reference():
    from repro.kernels.tdvmm import tdvmm as jk
    from repro_torch.kernels.tdvmm import tdvmm as tk
    # the port names a code dtype by its storage name; int4 codes travel
    # packed in int8 storage
    for name, jd in (("int8", jnp.int8), ("int4", jnp.int4),
                     ("f32", jnp.float32), ("f32x3", jnp.float32)):
        assert str(tk.acc_dtype_for(name)) == f"torch.{jk.acc_dtype_for(jd)}"
