"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points never drop to the CPU unless asked to."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs import get_config, smoke
from repro_torch.models import model
from repro_torch.runtime.engine import Engine, EngineConfig

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import jax|from jax|import repro($|[ .,])|from repro(\.| import))",
    re.M)


def _modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_importing_the_port_loads_no_jax_and_no_reference():
    mods = _modules()
    assert "repro_torch.runtime.engine" in mods and len(mods) > 20
    assert {"repro_torch.kernels.ssd.ops",
            "repro_torch.kernels.tdvmm.autotune_table",
            "repro_torch.launch.autotune_tdvmm"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_no_jax_or_reference_imports_in_source(path):
    text = (ROOT / path).read_text()
    assert not FORBIDDEN.search(text), path


def test_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke(get_config("qwen1.5-0.5b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_params(0, cfg)
    params = model.init_params(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, params, EngineConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.calibrate(params, {"inputs": torch.zeros((1, 4), dtype=torch.long)},
                        cfg)
    from repro_torch.launch import quickstart, serve, serve_lm
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen1.5-0.5b", "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main([])
    # asked for explicitly, the CPU path runs
    Engine(cfg, params, EngineConfig(), device="cpu")


def test_static_entry_point_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.launch import serve
    for arch, sites in (("mamba2-1.3b", "ssm.*"), ("mixtral-8x7b", "moe.*")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--arch", arch, "--smoke", "--static", "--tdvmm",
                        sites, "--calibrate"])
        # asked for explicitly, the CPU path runs
        out = serve.serve_static(smoke(get_config(arch)), 2, 5, 2,
                                 device="cpu")
        assert tuple(out["tokens"].shape) == (2, 2)


TRAINING_MODULES = (
    "repro_torch.tree", "repro_torch.optim.optimizer",
    "repro_torch.data.pipeline", "repro_torch.checkpoint.checkpoint",
    "repro_torch.runtime.fault", "repro_torch.launch.steps",
    "repro_torch.launch.train", "repro_torch.launch.train_lm")


@pytest.mark.parametrize("name", TRAINING_MODULES)
def test_training_modules_are_in_the_isolation_scan(name):
    # the import check above walks every module of the package; the source
    # check reads every file
    assert name in _modules()
    path = PORT.joinpath(*name.split(".")[1:]).with_suffix(".py")
    assert not FORBIDDEN.search(path.read_text()), path


FAULT_MODULES = (
    "repro_torch.runtime.faultinject", "repro_torch.runtime.engine",
    "repro_torch.core.calibration", "repro_torch.launch.serve")


@pytest.mark.parametrize("name", FAULT_MODULES)
def test_fault_modules_are_in_the_isolation_scan(name):
    assert name in _modules()
    path = PORT.joinpath(*name.split(".")[1:]).with_suffix(".py")
    assert not FORBIDDEN.search(path.read_text()), path


OBSERVABILITY_MODULES = (
    "repro_torch.runtime.telemetry", "repro_torch.runtime.sla",
    "repro_torch.runtime.trace", "repro_torch.launch.trace_report")


@pytest.mark.parametrize("name", OBSERVABILITY_MODULES)
def test_observability_modules_are_in_the_isolation_scan(name):
    # the port's own copies of the JAX package's pure-Python modules
    assert name in _modules()
    path = PORT.joinpath(*name.split(".")[1:]).with_suffix(".py")
    assert not FORBIDDEN.search(path.read_text()), path


SURFACE_MODULES = (
    "repro_torch.launch.quickstart", "repro_torch.launch.serve_lm",
    "repro_torch.launch.roofline_report")


@pytest.mark.parametrize("name", SURFACE_MODULES)
def test_example_and_report_modules_are_in_the_isolation_scan(name):
    # the port's counterparts of the JAX package's examples and of its
    # roofline generators, which read JSON and need no device
    assert name in _modules()
    path = PORT.joinpath(*name.split(".")[1:]).with_suffix(".py")
    assert not FORBIDDEN.search(path.read_text()), path


def test_drift_probe_refuses_a_missing_card(monkeypatch):
    from repro_torch.core.calibration import CalibrationState
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke(get_config("qwen1.5-0.5b"))
    params = model.init_params(0, cfg, device="cpu")
    batch = {"inputs": torch.zeros((1, 4), dtype=torch.long)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.drift_probe(params, batch, cfg, CalibrationState())
    # asked for explicitly, the CPU path runs
    fresh, clips = model.drift_probe(params, batch, cfg, CalibrationState(),
                                     device="cpu")
    assert fresh.windows == {} and clips == {}


def test_training_entry_points_refuse_a_missing_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.launch import perceptron, train, train_lm
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "qwen1.5-0.5b", "--smoke", "--tdvmm",
                    "--steps", "1", "--batch", "4", "--seq", "64",
                    "--ckpt-dir", str(tmp_path / "a")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm.main(["--steps", "1", "--ckpt-dir", str(tmp_path / "b")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perceptron.main(["--qat"])


DISTRIBUTED = ("launch/mesh.py", "launch/meshctx.py", "launch/sharding.py",
               "launch/pipeline.py", "optim/compression.py")


@pytest.mark.parametrize("path", DISTRIBUTED)
def test_the_distributed_modules_stand_alone(path):
    """The distributed slice's modules exist, are importable by the port's
    module walk (which the subprocess test above imports without loading
    JAX) and import neither JAX nor the JAX package."""
    name = "repro_torch." + path[:-3].replace("/", ".")
    assert name in _modules()
    assert not FORBIDDEN.search((PORT / path).read_text()), path


def test_init_distributed_refuses_a_missing_card(monkeypatch):
    from repro_torch.launch import mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.init_distributed()
