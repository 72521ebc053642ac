"""pytest settings of the benchmark's own tests (``python -m pytest
perfbench/tests`` from the repository's root): the ``card`` marker, for
tests that need an NVIDIA card; they decide inside a fixture whether one is
there and skip without it."""
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    # One CPU thread a process: the runs inside these tests are timed
    # windows, and several test processes that each spin up a thread per
    # core slow one another by orders of magnitude.
    torch.set_num_threads(1)
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")
