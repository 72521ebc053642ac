"""The port's production-mesh dry run (``launch.dryrun``) and its H100
roofline (``launch.roofline``): the JAX package's arithmetic (model FLOPs,
parameter counts, the terms), the kernel costs against chip_smoke.py's
bounds, a fake 2 x 2 world counting exactly what the same step counts on a
real 2 x 2 gloo world, and production cells at 16 x 16, run in a
subprocess so that the fake process group stays out of this one."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import torch_dist_cases as cases
from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.launch import roofline as jroof
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import constants as C
from repro_torch.launch import roofline
from torch_dist_cases import World

ROOT = Path(__file__).resolve().parents[1]


def _subprocess(code: str, timeout: float = 300) -> str:
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT / 'tests'}")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.splitlines()[-1]


@pytest.mark.parametrize("arch", list(JARCHS))
def test_model_flops_and_parameter_counts_equal_the_jax_package(arch):
    tc, jc = get_config(arch), jget(arch)
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    for name, shape in SHAPES.items():
        assert roofline.model_flops(tc, shape) == \
            jroof.model_flops(jc, JSHAPES[name]), name


def test_roofline_terms_arithmetic():
    by_class = {"bf16": 2.0e12, "int8": 4.0e12, "f32": 1.0e12}
    links = {"nvlink": 9.0e9, "ib": 1.0e9}
    t = roofline.RooflineTerms(
        chips=256, flops_per_device=sum(by_class.values()),
        bytes_per_device=6.7e10, coll_bytes_per_device=1.0e10,
        model_flops=5.0e14, flops_by_class=by_class,
        coll_bytes_by_link=links)
    want_c = 2.0e12 / 989e12 + 4.0e12 / 1979e12 + 1.0e12 / 495e12
    assert t.t_compute == pytest.approx(want_c, rel=1e-12)
    assert t.t_memory == pytest.approx(6.7e10 / 3.35e12, rel=1e-12)
    assert t.t_collective == pytest.approx(9.0e9 / 450e9 + 1.0e9 / 50e9,
                                           rel=1e-12)
    assert t.dominant == "collective"
    assert t.step_time_lower_bound == t.t_collective
    assert t.mfu == pytest.approx(5.0e14 / 256 / (t.t_collective * 989e12))
    assert t.flops_ratio == pytest.approx(5.0e14 / (7.0e12 * 256))
    # the JAX module's keys; without the breakdowns, the bf16 peak and the
    # InfiniBand rate
    j = jroof.RooflineTerms(chips=256, flops_per_device=7.0e12,
                            bytes_per_device=6.7e10,
                            coll_bytes_per_device=1.0e10, model_flops=5.0e14)
    assert list(t.as_dict()) == list(j.as_dict())
    plain = roofline.RooflineTerms(256, 7.0e12, 6.7e10, 1.0e10, 5.0e14)
    assert plain.t_compute == 7.0e12 / C.H100_BF16_FLOPS
    assert plain.t_collective == 1.0e10 / C.H100_IB_BW


def test_kernel_costs_are_chip_smokes_bounds():
    """The dry run's kernel terms and PERF.md's bound column agree: for
    every B1 / B2 storage and mode, B3 and B4, max(bytes / HBM rate,
    FLOPs / peak) is chip_smoke.py's bound."""
    cs = cases._chip_smoke()

    def bound(kernel, g):
        flops, cls, nbytes = roofline.kernel_cost(kernel, g)
        return max(nbytes / C.H100_HBM_BW, flops / roofline.PEAKS[cls]) * 1e3

    for codes in ("int8", "int4", "f32"):
        for kind, mode in (("raw", "raw"), ("fused", "window"),
                           ("calibrated", "window")):
            for e, ex, m, k, n in ((1, 1, 2048, 1024, 5632),
                                   (8, 8, 2049, 4096, 14336),
                                   (1, 1, 4, 7168, 2048)):
                case = dict(e=e, ex=ex, m=m, k=k, n=n, codes=codes, mode=mode)
                g = dict(e=e, ex=ex, m=m, k=k, n=n, codes=codes,
                         scales=kind != "raw", readout=kind != "raw")
                assert bound(kind, g) == pytest.approx(cs.bound(case)[0],
                                                       rel=1e-12)
    case = dict(e=1, ex=1, m=2048, k=1024, n=5632, mode="fused")
    g = dict(case, codes="f32x3", scales=True, readout=False)
    assert bound("fused", g) == pytest.approx(cs.f32x3_bound(case)[0],
                                              rel=1e-12)
    for b, l, h, p, gr, s, q, dtype in ((4, 512, 64, 64, 1, 128, 128,
                                         "bfloat16"),
                                        (2, 4096, 80, 64, 1, 64, 128,
                                         "float32")):
        case = dict(b=b, l=l, h=h, p=p, g=gr, s=s, q=q, dtype=dtype)
        g = dict(b=b, l=l, h=h, p=p, g=gr, s=s, q=q,
                 elt=2 if dtype == "bfloat16" else 4)
        assert bound("ssd", g) == pytest.approx(cs.ssd_bound(case)[0],
                                                rel=1e-12)
    assert bound("crossing", dict(b=4096, k=2049, n=2048)) == \
        pytest.approx(cs.crossing_bound(4096, 2049, 2048, 0)[0], rel=1e-12)


COUNTED = [("qwen1.5-0.5b", dict(name="t", seq_len=16, global_batch=8,
                                 kind="train")),
           ("zamba2-2.7b", dict(name="p", seq_len=16, global_batch=4,
                                kind="prefill")),
           ("kimi-k2-1t-a32b", dict(name="t", seq_len=8, global_batch=4,
                                    kind="train"))]


RANKS = (3,)        # the last rank of the 2 x 2 mesh (the dry run counts one)


@pytest.fixture(scope="module")
def world():
    with World(4, timeout=180.0) as w:
        yield w


@pytest.fixture(scope="module")
def fake_counts():
    code = (
        "import json\n"
        "import torch_dist_cases as cases\n"
        "from repro_torch.configs.base import ShapeConfig\n"
        "from repro_torch.launch import dryrun\n"
        f"cells = {COUNTED!r}\n"
        "out = [[dryrun.count_fake(cases.count_cfg(a), ShapeConfig(**s), "
        f"(2, 2), r)['counter'] for r in {RANKS!r}] for a, s in cells]\n"
        "print(json.dumps(out))\n")
    return json.loads(_subprocess(code))


@pytest.mark.parametrize("i", range(len(COUNTED)))
def test_fake_2x2_counts_what_the_real_2x2_step_counts(world, fake_counts,
                                                        i):
    """The same smoke step (every linear a 6-bit TD-VMM site) counted on
    a real 2 x 2 gloo world (the plain kernels on the CPU) and by the dry
    run on a fake 2 x 2 world (no launch): the ranks' FLOPs by class, HBM
    bytes, collective bytes by kind and link and kernel calls are equal
    (the live-byte peak is not: the plain versions allocate)."""
    arch, shape = COUNTED[i]
    real = world.run(cases.count_step, arch, shape)
    for r, a, b in zip(RANKS, [real[r] for r in RANKS], fake_counts[i]):
        a, b = dict(a), dict(b)
        a.pop("peak_step_bytes"), b.pop("peak_step_bytes")
        assert a == b, (r, {k: (a[k], b[k]) for k in a if a[k] != b[k]})
        assert sum(a["kernel_launches"].values()) > 0
        assert a["collective_bytes"]["total"] > 0


CELLS = [("yi-34b", "prefill_32k", ["--opt-level", "2"]),
         ("mamba2-1.3b", "long_500k", []),
         ("zamba2-2.7b", "long_500k", []),
         ("qwen1.5-0.5b", "train_4k", ["--tdvmm", "--microbatch", "1"]),
         ("yi-34b", "long_500k", []),
         ("kimi-k2-1t-a32b", "decode_32k", [])]


@pytest.fixture(scope="module")
def production(tmp_path_factory):
    """The CELLS at 16 x 16 through the CLI, depth cut to one layer (two
    for zamba2's group), in one subprocess; with yi-34b's per-rank
    parameter bytes against the sum of its placements' local shapes."""
    out = tmp_path_factory.mktemp("dryrun")
    code = (
        "import json, torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.launch import dryrun, sharding\n"
        "from repro_torch.launch.mesh import make_production_mesh\n"
        "from repro_torch.models import model\n"
        f"cells = {CELLS!r}\n"
        "for a, s, extra in cells:\n"
        "    layers = '2' if a.startswith('zamba2') else '1'\n"
        f"    rc = dryrun.main(['--arch', a, '--shape', s, '--layers', layers,"
        f" '--out', {str(out)!r}, '--force'] + extra)\n"
        "    assert rc == 0, (a, s)\n"
        "dryrun.fake_world(256, 0)\n"
        "mesh = make_production_mesh(device_type='cpu')\n"
        "cfg = dryrun.cut_depth(get_config('yi-34b'), 1)\n"
        "from torch._subclasses.fake_tensor import FakeTensorMode\n"
        "with FakeTensorMode():\n"
        "    whole = model.init_params(0, cfg, device='cpu')\n"
        "specs = sharding.param_specs(whole, cfg, mesh, dp_axes=(), "
        "ep_axes=('data',))\n"
        "from repro_torch.tree import leaves\n"
        "n = 0\n"
        "for t, sp in zip(leaves(whole), leaves(specs)):\n"
        "    k = 1\n"
        "    for d in sharding.local_shape(tuple(t.shape), sp, mesh):\n"
        "        k *= d\n"
        "    n += k * t.element_size()\n"
        "print(json.dumps(n))\n")
    want = json.loads(_subprocess(code, timeout=600))
    return out, want


@pytest.mark.parametrize("arch,shape,extra", CELLS)
def test_production_cells_at_16x16(production, arch, shape, extra):
    """yi-34b's 56 heads and 8 KV heads take the head-dim fallback at a
    model axis of 16; mamba2 and zamba2 run long_500k's batch of 1 with
    SSM tensor parallelism (zamba2's shared block on a sequence-split
    cache); qwen trains under TD-VMM with TP; yi-34b skips long_500k with
    the JAX package's reason; kimi-k2's 8 KV heads of 112 take the KV
    groups split, its decode cache one KV head a rank (1/8 of the whole
    heads' bytes), and the cell fits an H100.  Each cell writes the JAX
    package's keys."""
    out, param_bytes = production
    r = json.loads((out / f"{arch}__{shape}__pod1.json").read_text())
    if shape == "long_500k" and arch == "yi-34b":
        assert r["status"] == "skipped" and "524k" in r["reason"]
        return
    assert r["status"] == "ok", r.get("traceback")
    assert r["mesh"] == [16, 16] and r["chips"] == 256
    assert set(r["memory_analysis"]) == {
        "generated_code_size_in_bytes", "argument_size_in_bytes",
        "output_size_in_bytes", "temp_size_in_bytes", "alias_size_in_bytes"}
    assert set(r["roofline"]) == set(jroof.RooflineTerms(
        1, 1.0, 1.0, 1.0, 1.0).as_dict())
    assert r["roofline"]["step_time_lower_bound_s"] > 0
    assert r["fits_h100"] in (True, False) and r["peak_bytes"] > 0
    assert r["collective_bytes"]["total"] > 0
    if arch == "yi-34b":
        assert r["step"]["param_bytes"] == param_bytes
    if shape == "long_500k":
        assert r["step"]["sequence_split"] is True
        assert r["kernel_launches"].get("ssd", 0) == 0   # decode: no scan
    if "--tdvmm" in extra:
        assert r["kernel_launches"]["raw"] > 0
    if arch.startswith("kimi"):
        cfg, sh = get_config(arch), SHAPES[shape]
        rows, pos = sh.global_batch // 16, r["layers"] * sh.global_batch // 4
        whole_kv = (2 * r["layers"] * rows * sh.seq_len * cfg.n_kv_heads
                    * cfg.resolved_head_dim * 2)
        assert 8 * (r["step"]["cache_bytes"] - pos) == whole_kv
        assert r["fits_h100"] is True
