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


# ---------------------------------------------------------------------------
# B4's card arithmetic, emulated in float32 on the CPU
# ---------------------------------------------------------------------------
# B4 (csrc/crossing.cu) runs the same bisection, but wherever mid >= t_max[b]
# (the row's last onset) every relu of Q(mid) is the identity, so it takes
#   Q(mid) = mid * S[n] - M[b, n],  S = column sums of I,  M = t_on @ I,
# with M from one 3xTF32 product on the tensor cores; below t_max it sums
# the relus over K as before.  `emulate_b4` repeats that arithmetic: S in
# the prep kernel's order, M with TF32 rounded as `cvt.rna` rounds, k8
# block by k8 block within each 32-source stage, the linear step as a
# product and a difference each rounded to float32, the general step in
# blocks of 32 sources with each term an FMA.  Inside a stage each MMA's add into its accumulator rounds toward
# zero, as the tensor cores' does; the 8 products of one MMA are summed in
# float64, and the FMA is emulated in float64, rounded twice: those are the
# emulation's departures from the card.

# chip_smoke.py's gate on B4 against crossing_plain, max|dt| / T
CROSSING_RTOL_T = 2.5e-6


def _tf32(v):
    """``cvt.rna.tf32.f32``: the nearest TF32 value, ties away from zero
    (the low 13 bits of the float32 cleared after adding half of them)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _column_sums(cur):
    """S[n] in the prep kernel's order: 8 slices of the sources k = j mod 8,
    each summed in order, then the slices 0..7 in order."""
    k, n = cur.shape
    pad = torch.zeros(((k + 7) // 8 * 8, n), dtype=torch.float32)
    pad[:k] = cur
    parts = torch.zeros((8, n), dtype=torch.float32)
    for block in pad.view(-1, 8, n):
        parts = parts + block
    s = parts[0]
    for j in range(1, 8):
        s = s + parts[j]
    return s


def _mma_add(d, x):
    """d + x as the tensor cores accumulate: toward zero, not to nearest
    (the card showed it: summed over all of K so, M moved the times by
    3.55e-6 T from crossing_plain, against 8.9e-7 T to nearest)."""
    exact = d.double() + x.double()
    r = exact.float()
    over = r.double().abs() > exact.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _product(t_on, cur, passes=3, stage=32):
    """M = t_on @ cur as the fused kernel sums it: each stage of 32 sources
    on the tensor cores from zero, k8 block by k8 block, 3 passes (lo.hi,
    hi.lo, hi.hi) or 1 (hi.hi: one TF32 product), then added into M to
    nearest.  ``stage=None``: all of K in one accumulator on the tensor
    cores (the kernel's first version)."""
    a_hi, b_hi = _tf32(t_on), _tf32(cur)
    a_lo, b_lo = _tf32(t_on - a_hi), _tf32(cur - b_hi)
    pairs = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))[3 - passes:]
    k = t_on.shape[1]
    stage = stage or k
    m = torch.zeros((t_on.shape[0], cur.shape[1]), dtype=torch.float32)
    for s0 in range(0, k, stage):
        part = torch.zeros_like(m)
        for k0 in range(s0, min(s0 + stage, k), 8):
            ks = slice(k0, k0 + 8)
            for a, b in pairs:
                part = _mma_add(part, a[:, ks].double() @ b[ks].double())
        m = m + part
    return m


def _general_q(t_on, cur, mid):
    """Q(mid) as the general step sums it: blocks of 32 sources, each block
    fmaf(c, max(mid - t, 0), p) in order, then added to Q."""
    q = torch.zeros_like(mid)
    k = t_on.shape[1]
    for k0 in range(0, k, 32):
        p = torch.zeros_like(mid)
        for kk in range(k0, min(k0 + 32, k)):
            d = torch.clamp(mid - t_on[:, kk:kk + 1], min=0.0)
            p = (cur[kk].double() * d.double() + p.double()).float()
        q = q + p
    return q


def emulate_b4(t_on, cur, k_charge, t_lo, t_hi, iters, passes=3,
               stage=32):
    """B4's crossing times (B, N) and the count of (row, column, step)
    triples that took the general step; ``passes`` and ``stage`` as for
    ``_product``."""
    k_charge, t_lo, t_hi = (tref.f32(v) for v in (k_charge, t_lo, t_hi))
    t_max = (t_on.max(dim=1).values if t_on.shape[1]
             else torch.full((t_on.shape[0],), -np.inf))
    s, m = _column_sums(cur), _product(t_on, cur, passes, stage)
    lo = torch.full_like(m, t_lo)
    hi = torch.full_like(m, t_hi)
    general = 0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        slow = mid < t_max[:, None]
        q = mid * s - m
        if bool(slow.any()):
            general += int(slow.sum())
            q = torch.where(slow, _general_q(t_on, cur, mid), q)
        too_low = q < k_charge
        lo = torch.where(too_low, mid, lo)
        hi = torch.where(too_low, hi, mid)
    return 0.5 * (lo + hi), general


def _physics_operands(quadrants, b, n, seed):
    """B4's operands on the physics path: an n x n layer's weights U(-1, 1)
    and b inputs (U(-1, 1) four-quadrant, U(0, 1) two-quadrant), programmed
    and encoded by core/tdcore, the bias source as the last row."""
    from repro_torch.core import tdcore
    from repro_torch.launch.perceptron import SPEC

    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.uniform(-1.0, 1.0, (n, n)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(0.0, 1.0, (b, n)).astype(np.float32))
    operands = (tdcore.four_quadrant_operands(x * 2 - 1, w, SPEC)
                if quadrants == 4 else tdcore.two_quadrant_operands(x, w, SPEC))
    t_on, cur = tdcore.with_bias_source(*operands[:3])
    return t_on, cur, operands[3], SPEC.t_window_s


def _hold_emulation(t_on, cur, charge, t_window, iters=24):
    """The emulation against crossing_plain (CROSSING_RTOL_T of T) and the
    JAX crossing_ref (the bisection tolerance, scaled to t_hi = 2T);
    returns (emulated times, plain times, general-step count)."""
    t_hi = 2.0 * t_window
    got, general = emulate_b4(t_on, cur, charge, 0.0, t_hi, iters)
    plain = tref.crossing_plain(t_on, cur, charge, 0.0, t_hi, iters)
    assert float((got - plain).abs().max()) <= CROSSING_RTOL_T * t_window
    want = np.asarray(j_crossing_ref(jnp.asarray(t_on.numpy()),
                                     jnp.asarray(cur.numpy()), charge))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=BISECT_ATOL * t_window)
    return got, plain, general


# the physics path's B4 launches: the perceptron's four-quadrant layer
# (K 21, N 20), its two-quadrant layer (K 11, N 20), a 256 x 256 array
# (K 513, N 512)
PHYSICS = {"perceptron_four": (4, 64, 10), "perceptron_two": (2, 64, 10),
           "array_256": (4, 32, 256)}


@pytest.mark.parametrize("name", sorted(PHYSICS))
def test_b4_emulation_physics_operands_take_only_the_linear_step(name):
    quadrants, b, n = PHYSICS[name]
    t_on, cur, charge, t_window = _physics_operands(quadrants, b, n, seed=n)
    _, plain, general = _hold_emulation(t_on, cur, charge, t_window)
    # every crossing lies past every onset: mid >= t_max at every step
    assert general == 0
    assert float(plain.min()) > float(t_on.max())


@pytest.mark.parametrize("b,k,n", SHAPES)
def test_b4_emulation_matches_plain_and_reference(b, k, n):
    t_on, cur, charge = _inputs(b, k, n, seed=b * k + n)
    _hold_emulation(torch.from_numpy(t_on), torch.from_numpy(cur), charge,
                    1.0)


def test_b4_emulation_general_step_before_the_last_onset():
    """Onsets U(0, 2) and a small charge: most crossings fall before the
    row's last onset, so the general step carries most of the bisection."""
    rng = np.random.default_rng(17)
    t_on = torch.from_numpy(rng.uniform(0.0, 2.0, (8, 129)).astype(np.float32))
    cur = torch.from_numpy(rng.uniform(0.01, 1.0, (129, 48)).astype(np.float32))
    got, _, general = _hold_emulation(t_on, cur, 0.1 * 129, 1.0)
    assert general > 0
    assert float((got < t_on.max(dim=1).values[:, None]).double().mean()) > 0.5


def _onsets_at_t_max(b, k, n, seed):
    """A crossing exactly at t_max = 1: every row's onsets a permutation of
    the same multiples of 1/64 (one of them 1, one 0), every column's
    currents constant over the sources, c_n in {1/4, 1/2, 3/4, 1}.  Then
    Q(1) = c_n * sum(1 - t) holds exactly in float32 in any order, and the
    charge Q(1) at c_n = 1/2 puts those columns' crossing exactly at 1 (c_n
    above it before 1, below it after)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 65, k).astype(np.float32) / 64
    base[:2] = (0.0, 1.0)
    t_on = np.stack([rng.permutation(base) for _ in range(b)])
    c = (1 + np.arange(n) % 4).astype(np.float32) / 4
    cur = np.broadcast_to(c, (k, n)).copy()
    charge = float(0.5 * np.sum(1.0 - base, dtype=np.float64))
    return torch.from_numpy(t_on), torch.from_numpy(cur), charge


def test_b4_emulation_crossing_exactly_at_t_max():
    t_on, cur, charge = _onsets_at_t_max(4, 65, 16, seed=3)
    got, plain, general = _hold_emulation(t_on, cur, charge, 1.0)
    at_max = (torch.arange(16) % 4) == 1
    assert float((got[:, at_max] - 1.0).abs().max()) <= 2.0 ** -23
    # the columns that cross before t_max take the general step
    assert general > 0
    # the first step's mid is t_max itself: the linear step, exact there
    one, first = emulate_b4(t_on, cur, charge, 0.0, 2.0, 1)
    assert first == 0
    assert torch.equal(one, tref.crossing_plain(t_on, cur, charge, 0.0, 2.0,
                                                1))


def test_b4_emulation_saturates_at_t_hi():
    t_on, cur, _ = _inputs(2, 32, 128, seed=3)
    charge = float(np.sum(cur, axis=0).max() * 3.0)   # Q(2) < charge
    t, c = torch.from_numpy(t_on), torch.from_numpy(cur)
    got, general = emulate_b4(t, c, charge, 0.0, 2.0, 24)
    assert general == 0
    assert torch.equal(got, tref.crossing_plain(t, c, charge, 0.0, 2.0, 24))


# how M is summed: (passes, stage) of _product, and whether B4 then holds
# the gate at the array's K
PRODUCTS = {"3xtf32": (3, 32, True), "1xtf32": (1, 32, False),
            "3xtf32_one_accumulator": (3, None, False)}


@pytest.mark.parametrize("scheme", sorted(PRODUCTS))
def test_b4_emulation_needs_3xtf32_at_the_arrays_k(scheme, monkeypatch):
    """At the 1024 x 1024 array's K 2049 (8 of its rows, all 2048 columns),
    M in 3xTF32, each 32-source stage added into M to nearest, keeps B4
    within CROSSING_RTOL_T of crossing_plain.  One TF32 product (hi.hi)
    does not, nor 3xTF32 summed over all of K in the tensor cores'
    accumulator, which truncates."""
    passes, stage, holds = PRODUCTS[scheme]
    t_on, cur, charge, t_window = _physics_operands(4, 8, 1024, seed=1)
    assert tuple(t_on.shape) == (8, 2049) and tuple(cur.shape) == (2049, 2048)
    monkeypatch.setattr(tref, "PLAIN_CHUNK_BYTES", 4 * 4 * 2049 * 2048)
    plain = tref.crossing_plain(t_on, cur, charge, 0.0, 2.0 * t_window, 24)
    got, general = emulate_b4(t_on, cur, charge, 0.0, 2.0 * t_window, 24,
                              passes, stage)
    assert general == 0
    err = float((got - plain).abs().max()) / t_window
    assert (err <= CROSSING_RTOL_T) == holds


def test_general_steps_counts_the_steps_below_the_last_onset():
    """ref.general_steps replays crossing_plain's bisection: none at the
    physics operands, as many as the emulation takes in the constructed
    case (the two trajectories part only where Q(mid) ties the charge)."""
    t_on, cur, charge, t_window = _physics_operands(4, 16, 10, seed=2)
    assert tref.general_steps(t_on, cur, charge, 0.0, 2 * t_window) == 0
    rng = np.random.default_rng(17)
    t_on = torch.from_numpy(rng.uniform(0.0, 2.0, (8, 129)).astype(np.float32))
    cur = torch.from_numpy(rng.uniform(0.01, 1.0, (129, 48)).astype(np.float32))
    plain = tref.general_steps(t_on, cur, 0.1 * 129, 0.0, 2.0, 24)
    _, emulated = emulate_b4(t_on, cur, 0.1 * 129, 0.0, 2.0, 24)
    assert plain > 0.5 * 8 * 48 * 24
    assert abs(plain - emulated) <= 0.01 * plain
