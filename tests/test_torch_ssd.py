"""The SSD scan and the Mamba-2 pieces around it: the port's plain version of
kernel B3 (``ssd_plain``), its token-by-token oracle, the decode step and
the causal conv against the JAX package's, on the same seeded inputs.

The port's functions run in torch on the CPU and sum in other orders than
XLA does, so they agree within float32 rounding, not bitwise.  Each bound
below is stated relative to max|reference| and sits about 10x above what
was measured on these inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.ssd.ref import ssd_naive as j_ssd_naive
from repro.kernels.ssd.ssd import ssd_kernel as j_ssd_kernel
from repro.models import ssm as jssm
from repro_torch.kernels.ssd import ref as tref
from repro_torch.kernels.ssd import ssd as tssd
from repro_torch.models import ssm as tssm

# ssd_plain against the reference's ssd_chunked (the same chunked algebra,
# another summation order): measured <= 2.6e-7 of max|y|, state <= 4.5e-7.
CHUNKED_RTOL = 4e-6
# against the token-by-token recurrence (other algebra: per-token decays
# multiply up instead of exp of a cumulative sum): measured <= 2.4e-7; and
# the interpret-mode Pallas kernel: measured <= 1.7e-7.
NAIVE_RTOL = 3e-6
# bfloat16 x/b/c: both sides compute in float32 from the same bf16 inputs
# and round y to bf16 once, so y differs by at most one bf16 ulp of |y|
# (2^-8 relative), which bounds the error by 2^-7 of max|y|.
BF16_RTOL = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


# name: (B, L, H, P, G, S, chunk)
CASES = {
    "multiple_g1": (2, 32, 4, 8, 1, 16, 8),
    "multiple_g2": (2, 32, 4, 8, 2, 16, 16),
    "ragged_g1": (2, 21, 4, 8, 1, 16, 8),
    "ragged_g2": (1, 40, 4, 16, 2, 8, 16),
    "shorter_than_chunk_g2": (2, 13, 4, 8, 2, 8, 16),
}


def _inputs(b, l, h, p, g, s, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, l, h)))) * 0.1
          ).astype(np.float32)
    a_log = np.log(np.arange(1, h + 1, dtype=np.float32))
    bb = (rng.standard_normal((b, l, g, s)) * 0.3).astype(np.float32)
    cc = (rng.standard_normal((b, l, g, s)) * 0.3).astype(np.float32)
    return x, dt, a_log, bb, cc


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


@pytest.mark.parametrize("case", sorted(CASES))
def test_ssd_plain_matches_reference_chunked(case):
    *shape, chunk = CASES[case]
    arrs = _inputs(*shape)
    y, st = tssd.ssd_plain(*_t(*arrs), chunk)
    yj, stj = jssm.ssd_chunked(*_j(*arrs), chunk)
    assert tuple(y.shape) == yj.shape and tuple(st.shape) == stj.shape
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    assert _rel(y, yj) <= CHUNKED_RTOL
    assert _rel(st, stj) <= CHUNKED_RTOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_ssd_plain_and_port_oracle_match_reference_naive(case):
    *shape, chunk = CASES[case]
    arrs = _inputs(*shape, seed=1)
    yj, stj = j_ssd_naive(*_j(*arrs))
    y, st = tssd.ssd_plain(*_t(*arrs), chunk)
    assert _rel(y, yj) <= NAIVE_RTOL and _rel(st, stj) <= NAIVE_RTOL
    # the port's own oracle is the same recurrence, step for step
    yn, stn = tref.ssd_naive(*_t(*arrs))
    assert _rel(yn, yj) <= NAIVE_RTOL and _rel(stn, stj) <= NAIVE_RTOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_ssd_plain_matches_interpret_mode_kernel(case):
    """The reference's Pallas kernel, run in interpret mode as its own tests
    run it.  It takes L in whole chunks, so a ragged L is padded with
    dt = 0 (inert, as ``ssd_chunked`` pads) and the tail sliced off."""
    b, l, h, p, g, s, chunk = CASES[case]
    x, dt, a_log, bb, cc = _inputs(b, l, h, p, g, s, seed=2)
    q = min(chunk, l)
    pad = (-l) % q
    padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
              for a in (x, dt, bb, cc)]
    yk = np.asarray(j_ssd_kernel(*_j(padded[0], padded[1], a_log, padded[2],
                                     padded[3]), chunk=q, interpret=True))
    y, _ = tssd.ssd_plain(*_t(x, dt, a_log, bb, cc), chunk)
    assert _rel(y, yk[:, :l]) <= NAIVE_RTOL


@pytest.mark.parametrize("case", ["multiple_g1", "multiple_g2"])
def test_ssd_op_matches_reference_op(case):
    """``ssd.ops.ssd`` (y alone) against the JAX package's ``ssd.ops.ssd``,
    its Pallas kernel in interpret mode; on the CPU it is ``ssd_plain``'s y
    and launches no kernel."""
    from repro.kernels.ssd import ops as jssd_ops
    from repro_torch.kernels.ssd import ops as tssd_ops
    b, l, h, p, g, s, chunk = CASES[case]
    arrs = _inputs(b, l, h, p, g, s, seed=6)
    yj = np.asarray(jssd_ops.ssd(*_j(*arrs), chunk=chunk, interpret=True))
    tssd.reset_launches()
    y = tssd_ops.ssd(*_t(*arrs), chunk)
    assert tssd.LAUNCHES["ssd"] == 0
    assert torch.equal(y, tssd.ssd_plain(*_t(*arrs), chunk)[0])
    assert _rel(y, yj) <= NAIVE_RTOL


def test_ssd_plain_bfloat16_inputs():
    b, l, h, p, g, s, chunk = CASES["ragged_g2"]
    x, dt, a_log, bb, cc = _inputs(b, l, h, p, g, s, seed=3)
    xt, bt, ct = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, bb, cc))
    y, st = tssd.ssd_plain(xt, torch.from_numpy(dt), torch.from_numpy(a_log),
                           bt, ct, chunk)
    xj, bj, cj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, bb, cc))
    yj, stj = jssm.ssd_chunked(xj, jnp.asarray(dt), jnp.asarray(a_log), bj,
                               cj, chunk)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    assert _rel(y.float(), np.asarray(yj.astype(jnp.float32))) <= BF16_RTOL
    assert _rel(st, stj) <= CHUNKED_RTOL


def test_ssd_op_routes_cpu_tensors_to_the_plain_version():
    *shape, chunk = CASES["ragged_g2"]
    arrs = _t(*_inputs(*shape, seed=4))
    tssd.reset_launches()
    y, st = tssd.ssd_plain(*arrs, chunk)
    y2, st2 = tssd.ssd_scan(*arrs, chunk)
    assert torch.equal(y2, y) and torch.equal(st2, st)
    assert tssd.LAUNCHES["ssd"] == 0            # no kernel ran on the CPU
    with pytest.raises(ValueError, match="inconsistent"):
        tssd.ssd_scan(arrs[0], arrs[1], arrs[2][:1], arrs[3], arrs[4], chunk)


def test_ssd_scan_refuses_a_device_other_than_cpu_or_cuda():
    *shape, chunk = CASES["ragged_g2"]
    arrs = [t.to("meta") for t in _t(*_inputs(*shape, seed=4))]
    tssd.reset_launches()
    with pytest.raises(ValueError, match="runs on cuda"):
        tssd.ssd_scan(*arrs, chunk)
    assert tssd.LAUNCHES["ssd"] == 0


@pytest.mark.parametrize("dtype,p,s,want", [
    (torch.bfloat16, 64, 128, (1, 1)),      # mamba2-1.3b's rows
    (torch.bfloat16, 24, 40, (1, 1)),       # 48- and 80-byte rows
    (torch.bfloat16, 20, 34, (0, 0)),       # 40- and 68-byte rows
    (torch.float32, 18, 30, (0, 0)),        # 72- and 120-byte rows
    (torch.float32, 64, 30, (1, 0)),
])
def test_staging_takes_16_byte_copies_only_for_aligned_rows(dtype, p, s,
                                                            want):
    x = torch.zeros((1, 4, 2, p), dtype=dtype)
    b = torch.zeros((1, 4, 1, s), dtype=dtype)
    assert tssd.staging(x, b, b.clone()) == want
    if want[0]:                             # a base off the 16-byte grid
        off = torch.zeros((1, 4, 2, p + 1), dtype=dtype)[..., 1:]
        assert tssd.staging(off, b, b)[0] == 0


def test_ssd_scan_of_an_empty_sequence_leaves_a_zero_state():
    b, _, h, p, g, s, chunk = CASES["ragged_g2"]
    x, dt, a_log, bb, cc = _t(*_inputs(b, 0, h, p, g, s, seed=6))
    y, st = tssd.ssd_scan(x, dt, a_log, bb, cc, chunk)
    assert y.shape == (b, 0, h, p) and y.dtype == x.dtype
    assert st.shape == (b, h, p, s) and st.dtype == torch.float32
    assert not st.any()


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_decode_step_matches_reference(g):
    b, h, p, s = 3, 4, 8, 16
    rng = np.random.default_rng(5 + g)
    state = rng.standard_normal((b, h, p, s)).astype(np.float32)
    x = rng.standard_normal((b, h, p)).astype(np.float32)
    dt = (rng.uniform(0.01, 0.2, (b, h))).astype(np.float32)
    a_log = np.log(np.arange(1, h + 1, dtype=np.float32))
    bb = rng.standard_normal((b, g, s)).astype(np.float32)
    cc = rng.standard_normal((b, g, s)).astype(np.float32)
    y, st = tssm.ssd_decode_step(*_t(state, x, dt, a_log, bb, cc))
    yj, stj = jssm.ssd_decode_step(*_j(state, x, dt, a_log, bb, cc))
    assert _rel(y, yj) <= CHUNKED_RTOL and _rel(st, stj) <= CHUNKED_RTOL


@pytest.mark.parametrize("left", [False, True])
@pytest.mark.parametrize("L", [1, 7])
def test_conv1d_with_left_context_matches_reference(L, left):
    b, width, ch = 2, 4, 24
    rng = np.random.default_rng(L + 10 * left)
    x = rng.standard_normal((b, L, ch)).astype(np.float32)
    w = (rng.standard_normal((width, 1, ch)) * 0.1).astype(np.float32)
    bias = rng.standard_normal((ch,)).astype(np.float32)
    ctx = rng.standard_normal((b, width - 1, ch)).astype(np.float32) \
        if left else None
    y, new_ctx = tssm._conv1d(*_t(x, w, bias),
                              None if ctx is None else torch.from_numpy(ctx))
    yj, new_ctx_j = jssm._conv1d(*_j(x, w, bias),
                                 None if ctx is None else jnp.asarray(ctx))
    # four float32 products summed: a few ulps of the largest term
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(new_ctx.numpy(), np.asarray(new_ctx_j))


# ---------------------------------------------------------------------------
# B3's arithmetic on the card, emulated on the CPU
# ---------------------------------------------------------------------------
# The card's B3 (csrc/ssd.cu) takes the scan apart by chunk: C.B^T once per
# (row, group, chunk), each chunk's own end state, a pass that carries the
# state over the chunks, then y = W.x + exp(cum) (C.prev^T).  Its four
# products run on the tensor cores in TF32: an operand that is not exact in
# TF32 (float32 x, B, C; always W, x * dec and the carried state) is split
# into hi = tf32(v) and lo = tf32(v - hi), rounded to nearest with ties away
# (cvt.rna), and the product summed as lo.hi + hi.lo + hi.hi; bfloat16
# x, B and C are exact and go whole.  The prefix sum of dt * a runs in the
# plain version's order.  This emulation repeats those roundings in torch
# (float32 products of the rounded operands, exact as on the tensor cores)
# and is held to the gate that chip_smoke.py holds the kernel to.
SSD_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7, "state": 1e-5}
# name: (B, L, H, P, G, S, chunk, dtype): mamba2-1.3b's per-row full width,
# and a grouped case whose length is not a multiple of the chunk
B3_CASES = {
    "mamba2_row_bf16": (1, 512, 64, 64, 1, 128, 128, torch.bfloat16),
    "mamba2_row_f32": (1, 512, 64, 64, 1, 128, 128, torch.float32),
    "grouped_ragged_f32": (2, 300, 4, 64, 2, 128, 128, torch.float32),
}


def _tf32(v):
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _bf16(v):
    return v.to(torch.bfloat16).to(torch.float32)


def _product(a, b, a_exact, b_exact, rnd):
    """a @ b as B3 multiplies: split operands, lo.hi + hi.lo + hi.hi."""
    ah = a if a_exact else rnd(a)
    bh = b if b_exact else rnd(b)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    if not a_exact:
        out = out + rnd(a - ah) @ bh
    if not b_exact:
        out = out + ah @ rnd(b - bh)
    return out + ah @ bh


def _warp_scan(v):
    """Inclusive sum along the last axis as a warp scan would associate it:
    4 consecutive values per lane, then a Hillis-Steele scan over lanes."""
    q = v.shape[-1]
    qp = -(-q // 4) * 4
    loc = torch.cumsum(F.pad(v, (0, qp - q)).reshape(*v.shape[:-1], -1, 4), -1)
    tot = loc[..., -1]
    d = 1
    while d < tot.shape[-1]:
        tot = tot + F.pad(tot[..., :-d], (d, 0))
        d *= 2
    return (loc + (tot - loc[..., -1])[..., None]).reshape(
        *v.shape[:-1], qp)[..., :q]


def b3_emulation(x, dt, a_log, b, c, chunk, split="tf32", scan="sequential"):
    """(y, final state) as B3 computes them; ``split="bf16"`` or
    ``scan="warp"`` emulate the alternatives the kernel does not take."""
    rnd = _tf32 if split == "tf32" else _bf16
    exact = x.dtype == torch.bfloat16
    bsz, L, H, Pd = x.shape
    G, S = b.shape[2], b.shape[3]
    x, dt, b, c, q = tssd._pad_len(x, dt, b, c, chunk)
    nc, rep = x.shape[1] // q, H // G
    xf, bf, cf = x.float(), b.float(), c.float()
    a = -torch.exp(a_log)
    causal = torch.ones(q, q, dtype=torch.bool).tril()
    y = torch.zeros(bsz, nc * q, H, Pd)
    state = torch.zeros(bsz, H, Pd, S)
    for ci in range(nc):
        sl = slice(ci * q, ci * q + q)
        for g in range(G):
            gm = _product(cf[:, sl, g], bf[:, sl, g].transpose(1, 2), exact,
                          exact, rnd)
            for h in range(g * rep, (g + 1) * rep):
                dth = dt[:, sl, h]
                cum = (torch.cumsum if scan == "sequential" else
                       lambda v, _: _warp_scan(v))(dth * a[h], -1)
                tot = cum[:, -1]
                dec = torch.exp(tot[:, None] - cum) * dth
                xh = xf[:, sl, h]
                own = _product((xh * dec[..., None]).transpose(1, 2),
                               bf[:, sl, g], False, exact, rnd)
                w = gm * torch.exp(cum[:, :, None] - cum[:, None, :]) \
                    * dth[:, None, :]
                w = torch.where(causal, w, torch.zeros(()))
                inter = _product(cf[:, sl, g], state[:, h].transpose(1, 2),
                                 exact, False, rnd)
                y[:, sl, h] = _product(w, xh, False, exact, rnd) \
                    + torch.exp(cum)[..., None] * inter
                state[:, h] = state[:, h] * torch.exp(tot)[:, None, None] + own
    return y[:, :L].to(x.dtype), state


def _b3_inputs(b, l, h, p, g, s, dtype, seed):
    """chip_smoke.py's B3 inputs (dt ~ softplus(N(0,1) - 3), a_log =
    log(1..H), B and C ~ 0.3 N(0,1)), drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)) - 3.0)
                  ).astype(np.float32)
    a_log = np.log(np.arange(1, h + 1, dtype=np.float32))
    bb = (rng.standard_normal((b, l, g, s)) * 0.3).astype(np.float32)
    cc = (rng.standard_normal((b, l, g, s)) * 0.3).astype(np.float32)
    return x, dt, a_log, bb, cc


@pytest.mark.parametrize("case", sorted(B3_CASES))
def test_b3_precision_scheme_holds_the_gate(case):
    b, l, h, p, g, s, chunk, dtype = B3_CASES[case]
    x, dt, a_log, bb, cc = _b3_inputs(b, l, h, p, g, s, dtype, seed=16)
    xt, bt, ct = (torch.from_numpy(v).to(dtype) for v in (x, bb, cc))
    args = (xt, torch.from_numpy(dt), torch.from_numpy(a_log), bt, ct)
    y, st = b3_emulation(*args, chunk)
    yp, sp = tssd.ssd_plain(*args, chunk)
    assert y.dtype == yp.dtype == dtype and y.shape == yp.shape
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    assert _rel(y.float(), yp.float()) <= SSD_RTOL[name]
    assert _rel(st, sp) <= SSD_RTOL["state"]
    # and the reference's ssd_chunked, from the same (bf16-rounded) inputs.
    # XLA associates the prefix sum of dt * a otherwise than torch does, so
    # at this width ssd_plain itself sits up to 1.4e-5 of max|y| from it
    # (float32, a down to -64): the emulation may be no further from the
    # reference than ssd_plain is, plus the gate.
    jin = [jnp.asarray(v.float().numpy()) for v in (xt, bt, ct)]
    if dtype == torch.bfloat16:
        jin = [v.astype(jnp.bfloat16) for v in jin]
    yj, stj = jssm.ssd_chunked(jin[0], jnp.asarray(dt), jnp.asarray(a_log),
                               jin[1], jin[2], chunk)
    yj = np.asarray(yj.astype(jnp.float32))
    assert _rel(y.float(), yj) <= _rel(yp.float(), yj) + SSD_RTOL[name]
    assert _rel(st, stj) <= _rel(sp, stj) + SSD_RTOL["state"]


def emulation_report(seed: int = 16) -> None:
    """Prints, for each B3_CASES case, the emulated error against
    ``ssd_plain`` of the scheme B3 takes and of the two it does not (bf16
    halves; a warp-scan prefix sum):
    ``PYTHONPATH=src python -c "import sys; sys.path.insert(0, 'tests');
    import test_torch_ssd as t; t.emulation_report()"``."""
    for case in sorted(B3_CASES):
        b, l, h, p, g, s, chunk, dtype = B3_CASES[case]
        x, dt, a_log, bb, cc = _b3_inputs(b, l, h, p, g, s, dtype, seed)
        args = tuple(torch.from_numpy(v) for v in (x, dt, a_log, bb, cc))
        args = (args[0].to(dtype), args[1], args[2], args[3].to(dtype),
                args[4].to(dtype))
        yp, sp = tssd.ssd_plain(*args, chunk)
        for split, scan in (("tf32", "sequential"), ("bf16", "sequential"),
                            ("tf32", "warp")):
            y, st = b3_emulation(*args, chunk, split=split, scan=scan)
            print(f"{case} split={split} scan={scan}: y "
                  f"{_rel(y.float(), yp.float()):.3g} state "
                  f"{_rel(st, sp):.3g} of max|plain|")


# ---------------------------------------------------------------------------
# The scan under autograd (the training path's scan is ssd_plain)
# ---------------------------------------------------------------------------
# ssd_plain's gradients against jax.vjp of the reference's ssd_chunked, each
# relative to its input's max|g| (a_log's a sum over every position):
# measured <= 7.8e-7.
SCAN_GRAD_RTOL = 1e-5


def _scan_grads_t(arrs, chunk, gy):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    y, _ = tssd.ssd_plain(*ts, chunk)
    return [g.numpy() for g in torch.autograd.grad(
        (y * torch.from_numpy(gy)).sum(), ts)]


def _scan_grads_j(fn, arrs, gy):
    return jax.grad(lambda *a: jnp.sum(fn(*a)[0] * jnp.asarray(gy)),
                    argnums=(0, 1, 2, 3, 4))(*_j(*arrs))


@pytest.mark.parametrize("case", sorted(CASES))
def test_ssd_plain_gradients_match_reference_chunked(case):
    *shape, chunk = CASES[case]
    arrs = _inputs(*shape, seed=2)
    gy = np.random.default_rng(3).standard_normal(arrs[0].shape).astype(
        np.float32)
    got = _scan_grads_t(arrs, chunk, gy)
    want = _scan_grads_j(lambda *a: jssm.ssd_chunked(*a, chunk), arrs, gy)
    for name, g, w in zip(("x", "dt", "a_log", "b", "c"), got, want):
        assert _rel(g, w) <= SCAN_GRAD_RTOL, name


def test_ssd_plain_gradient_stays_finite_where_the_reference_overflows():
    """dt * a of -128 a step: exp(cum_i - cum_j) above the chunk's
    diagonal overflows.  The reference masks after the exp, so its
    gradient is 0 * inf = NaN there; the port masks before it (exp(-inf)
    = 0), the same forward values and the token-by-token recurrence's
    gradient."""
    x, _, a_log, bb, cc = _inputs(1, 16, 2, 4, 1, 4)
    dt = np.full((1, 16, 2), 2.0, np.float32)
    a_log[1] = np.float32(np.log(64.0))
    arrs = (x, dt, a_log, bb, cc)
    gy = np.ones_like(x)
    y, _ = tssd.ssd_plain(*_t(*arrs), 8)
    assert _rel(y, jssm.ssd_chunked(*_j(*arrs), 8)[0]) <= CHUNKED_RTOL
    ref = _scan_grads_j(lambda *a: jssm.ssd_chunked(*a, 8), arrs, gy)
    assert bool(jnp.isnan(ref[1]).any())
    got = _scan_grads_t(arrs, 8, gy)
    naive = _scan_grads_j(j_ssd_naive, arrs, gy)
    for name, g, w in zip(("x", "dt", "a_log", "b", "c"), got, naive):
        assert np.isfinite(g).all(), name
        assert _rel(g, w) <= NAIVE_RTOL, name


def test_softplus_gradient_is_logaddexps():
    x = np.random.default_rng(4).standard_normal(64).astype(np.float32) * 6
    t = torch.from_numpy(x).requires_grad_(True)
    out = tssm._softplus(t)
    g, = torch.autograd.grad(out.sum(), t)
    # exp and log1p round as each library's own: within float32 rounding
    assert _rel(out.detach(), jax.nn.softplus(jnp.asarray(x))) <= 1e-6
    want = np.asarray(jax.grad(lambda v: jnp.sum(jax.nn.softplus(v)))(
        jnp.asarray(x)))
    assert _rel(g, want) <= 1e-6
