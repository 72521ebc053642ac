"""Nothing the harness, its drivers or its metric readers load has the
top-level name ``jax``, ``jaxlib``, ``flax`` or ``repro`` (compared as the
whole part of the module name before the first dot: the port,
``repro_torch``, begins with ``repro``), and the reference loads nothing of
the program either.  Each import runs in a fresh interpreter."""
import subprocess
import sys

import pytest

from perfbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def loaded_top_names(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         f"sys.path[:0] = [{str(harness.ROOT)!r}, "
         f"{str(harness.ROOT / 'src')!r}]\n" + code +
         "\nprint(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, check=True, cwd=harness.ROOT,
        timeout=300)
    return set(out.stdout.split())


def test_harness_drivers_and_metrics():
    names = loaded_top_names(
        "from perfbench import harness, control\n"
        "import importlib, pathlib\n"
        "for kind in ('drivers', 'metrics', 'checks'):\n"
        "    for f in sorted((harness.BENCH / kind).glob('*.py')):\n"
        "        importlib.import_module(f'perfbench.{kind}.{f.stem}')\n"
        "for m in ('configs.archs', 'models.model', 'runtime.engine'):\n"
        "    importlib.import_module('repro_torch.' + m)\n")
    assert "repro_torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


@pytest.mark.parametrize("mod", ["perfbench.reference.lm",
                                 "perfbench.reference.judge"])
def test_reference_loads_nothing_of_the_program(mod):
    names = loaded_top_names(f"import {mod}")
    assert not names & (FORBIDDEN | {"repro_torch"}), names
