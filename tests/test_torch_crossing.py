"""The threshold-crossing solve: the port's plain version of kernel B4
(``crossing_plain``) and its sort-based oracle (``crossing_exact``) against
the JAX package's Pallas kernel (interpret mode) and ``crossing_ref``, on the
same seeded inputs, and the wrapper's CPU route.

Both bisections take the same halves unless Q(mid) lies within the sum's
rounding of the charge, so they agree within the bisection tolerance of
``tests/test_kernels.py`` (atol 2e-6 at t_hi = 2, iters = 30)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.crossing.crossing import crossing_kernel as j_crossing_kernel
from repro.kernels.crossing.ref import crossing_ref as j_crossing_ref
from repro_torch.kernels.crossing import crossing as tcross
from repro_torch.kernels.crossing import ops as tops
from repro_torch.kernels.crossing import ref as tref

# the bisection tolerance of tests/test_kernels.py::test_crossing_shapes;
# measured <= 2.4e-7 here
BISECT_ATOL = 2e-6
# two sort-based exact solves in float32: the same algebra, cumulative sums
# in another order (XLA against torch); measured <= 3.6e-7 here
EXACT_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


# (B, K, N): the shapes of tests/test_kernels.py, and a ragged N = 20 (the
# perceptron's two wires of 10 columns)
SHAPES = [(1, 32, 128), (4, 64, 128), (2, 128, 256), (3, 21, 20)]


def _inputs(b, k, n, seed=0):
    rng = np.random.default_rng(seed)
    t_on = rng.uniform(0.0, 1.0, (b, k)).astype(np.float32)
    cur = rng.uniform(0.01, 1.0, (k, n)).astype(np.float32)
    return t_on, cur, float(0.3 * k)


@pytest.mark.parametrize("b,k,n", SHAPES)
def test_crossing_plain_matches_pallas_kernel(b, k, n):
    t_on, cur, charge = _inputs(b, k, n, seed=b * k + n)
    want = j_crossing_kernel(jnp.asarray(t_on), jnp.asarray(cur), charge,
                             t_hi=2.0, iters=30, interpret=True)
    got = tref.crossing_plain(torch.from_numpy(t_on), torch.from_numpy(cur),
                              charge, t_hi=2.0, iters=30)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=BISECT_ATOL, rtol=0)


@pytest.mark.parametrize("b,k,n", SHAPES)
def test_crossing_exact_matches_reference(b, k, n):
    t_on, cur, charge = _inputs(b, k, n, seed=7 + b * k + n)
    want = j_crossing_ref(jnp.asarray(t_on), jnp.asarray(cur), charge)
    got = tref.crossing_exact(torch.from_numpy(t_on), torch.from_numpy(cur),
                              charge)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=EXACT_ATOL, rtol=0)


@pytest.mark.parametrize("seed", range(4))
def test_crossing_plain_converges_to_exact(seed):
    """Bisection resolves the sort-based crossing to the bisection
    tolerance (as tests/test_kernels.py's property test does)."""
    t_on, cur, _ = _inputs(2, 32, 128, seed=seed)
    charge = float((0.05 + 0.2 * seed) * 0.5 * 32)
    t, c = torch.from_numpy(t_on), torch.from_numpy(cur)
    got = tref.crossing_plain(t, c, charge, t_hi=2.0, iters=32)
    want = tref.crossing_exact(t, c, charge)
    assert float((got - want).abs().max()) < 2.0 / (1 << 30) + 1e-6


@pytest.mark.parametrize("b,k,n", [(2, 32, 128), (3, 21, 20)])
def test_crossing_saturates_at_t_hi(b, k, n):
    """A crossing beyond t_hi: both bisections return t_hi to within their
    last bracket (it never moves past t_hi; at t_hi = 2 and 24 steps the
    middle of the last bracket rounds to 2 itself in float32); the exact
    solve extrapolates past it."""
    t_on, cur, _ = _inputs(b, k, n, seed=3)
    charge = float(np.sum(cur, axis=0).max() * 3.0)   # Q(2) < charge
    t_hi, iters = 2.0, 24
    want = np.asarray(j_crossing_kernel(
        jnp.asarray(t_on), jnp.asarray(cur), charge, t_hi=t_hi, iters=iters,
        interpret=True))
    t, c = torch.from_numpy(t_on), torch.from_numpy(cur)
    got = tref.crossing_plain(t, c, charge, t_hi=t_hi, iters=iters).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(got <= t_hi)
    assert np.all(got >= t_hi * (1.0 - 2.0 ** -iters))
    assert bool((tref.crossing_exact(t, c, charge) > t_hi).all())


def test_crossing_plain_chunks_rows_bitwise(monkeypatch):
    t_on, cur, charge = _inputs(9, 21, 20, seed=5)
    t, c = torch.from_numpy(t_on), torch.from_numpy(cur)
    whole = tref.crossing_plain(t, c, charge, t_hi=2.0)
    # a budget of two rows' temporaries: chunks of 2, 2, 2, 2 and 1 rows
    monkeypatch.setattr(tref, "PLAIN_CHUNK_BYTES", 2 * 4 * 21 * 20)
    chunked = tref.crossing_plain(t, c, charge, t_hi=2.0)
    assert torch.equal(whole, chunked)


def test_wrapper_takes_the_plain_version_on_cpu_without_counting():
    t_on, cur, charge = _inputs(4, 33, 20, seed=11)
    t, c = torch.from_numpy(t_on), torch.from_numpy(cur)
    tcross.reset_launches()
    got = tcross.crossing_kernel(t, c, charge, t_lo=0.0, t_hi=2.0, iters=24)
    assert torch.equal(got, tref.crossing_plain(t, c, charge, 0.0, 2.0, 24))
    # ops.crossing_times solves over [0, 2T]
    assert torch.equal(tops.crossing_times(t, c, charge, 1.0), got)
    assert tcross.LAUNCHES == {"crossing": 0}


@pytest.mark.parametrize("bad", ["shape", "dtype", "iters"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    t = torch.zeros((2, 5))
    c = torch.ones((5, 3))
    kwargs = {}
    if bad == "shape":
        c = torch.ones((4, 3))
    elif bad == "dtype":
        t = t.double()
    else:
        kwargs["iters"] = -1
    with pytest.raises(ValueError):
        tcross.crossing_kernel(t, c, 1.0, **kwargs)
