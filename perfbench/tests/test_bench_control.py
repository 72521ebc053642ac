"""On the card: the control (the plain reference computed in float8, put in
the program's place) comes out not correct under each cell's limits, and
the program on the same seed comes out correct.  A window of the cell's
own length (as many served tokens as a run judges); run from the
repository's root with ``python -m pytest -m card perfbench/tests``."""
import time

import pytest

from perfbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_and_program_passes(card, name):
    res = harness.run_cell(name, 2**31 + 99, BENCH["run_seconds"], False,
                           time.time(), bench=BENCH, control=True)
    ctl = res["reference"]["control"]
    assert res["correct"], res["why_not_correct"]
    assert any(ctl[k] > c["limit"] for k, c in res["checks"].items()), ctl
