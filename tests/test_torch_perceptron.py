"""The port's entry point for the paper's circuit, ``launch/perceptron``, on
the CPU: the 10 x 10 x 10 case study and a small four-quadrant array against
their closed forms and against the JAX package's simulator on the same
weights, and the refusal to run without a card unless asked for the CPU.

Decoded outputs are held within TD_ATOL: the port's bisection over [0, 2T]
(24 steps, 2^-23 of T) against exact or float64 closed forms, in float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import energy as jenergy
from repro.core import tdcore as jtd
from repro.core.constants import TDVMMSpec as JSpec
from repro_torch.kernels.crossing import crossing as tcross
from repro_torch.launch import perceptron

# the same bound as tests/test_torch_tdcore.py and chip_smoke.py's TD_ATOL
TD_ATOL = 2.5e-6


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module")
def cli_run():
    tcross.reset_launches()
    out = perceptron.main(["--n", "64", "--batch", "16", "--device", "cpu"])
    return out, dict(tcross.LAUNCHES)


def test_cli_on_cpu_meets_the_closed_forms(cli_run):
    out, launches = cli_run
    case, arr = out["case_study"], out["array"]
    assert tuple(case["y"].shape) == (64, 10) and case["y"].device.type == "cpu"
    assert tuple(arr["y"].shape) == (16, 64)
    for err in (case["max_err"], case["max_err_dibl"], arr["max_err"]):
        assert 0.0 <= err <= TD_ATOL
    # the CPU path takes the plain version: no kernel launch is counted
    assert launches == {"crossing": 0}


def test_cli_on_cpu_reports_the_paper_numbers(cli_run):
    case, arr = cli_run[0]["case_study"], cli_run[0]["array"]
    spec = JSpec(bits=6)
    assert case["pipeline"] == jtd.pipeline_schedule(2, 64, spec)
    assert case["energy_pj_per_inference"] == pytest.approx(
        2 * jenergy.cost(10, bits=6).e_total_j * 1e12, rel=1e-12)
    assert arr["fj_per_op"] == pytest.approx(
        jenergy.cost(64, bits=6).e_per_op_j * 1e15, rel=1e-12)
    # DIBL at the operating point is under 2% (the paper's 5-6 bits)
    assert 0.0 < case["dibl_error"] < 0.02
    assert case["argmax_agree"] == 1.0
    assert 0.9 <= case["argmax_agree_twin"] <= 1.0


@pytest.mark.parametrize("seed", [0, 3])
def test_case_study_matches_the_reference_simulator(seed):
    """The port's perceptron on its seeded weights equals the JAX package's
    simulator on the same weights, clean and DIBL-perturbed."""
    out = perceptron.case_study("cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed)
    draw = [perceptron._uniform(gen, s, "cpu").numpy()
            for s in ((10, 10), (10, 10), (64, 10))]
    w1, w2, x = draw
    want = jtd.td_mlp_forward_batched(jnp.asarray(x), jnp.asarray(w1),
                                      jnp.asarray(w2), JSpec(bits=6))
    np.testing.assert_allclose(out["y"].numpy(), np.asarray(want),
                               atol=TD_ATOL, rtol=0)


def test_array_matches_the_reference_simulator():
    out = perceptron.array("cpu", n=32, batch=6, seed=2)
    gen = torch.Generator().manual_seed(3)
    w = perceptron._uniform(gen, (32, 32), "cpu").numpy()
    x = perceptron._uniform(gen, (6, 32), "cpu").numpy()
    want = jtd.td_vmm_four_quadrant_batched(jnp.asarray(x), jnp.asarray(w),
                                            JSpec(bits=6))
    np.testing.assert_allclose(out["y"].numpy(), np.asarray(want),
                               atol=TD_ATOL, rtol=0)


def test_entry_point_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perceptron.main(["--n", "8", "--batch", "2"])
