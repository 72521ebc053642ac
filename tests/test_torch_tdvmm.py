"""TD-VMM integrate + readout: the port's ops (plain path of kernels B1/B2 on
the CPU) are bitwise the JAX package's ``backend="jnp"`` for every readout
mode, batched E, shared-x and ragged shapes, in int8, float32 and int4-pair
code storage; the port's oracle is bitwise the JAX oracle."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tdvmm import ops as jops
from repro.kernels.tdvmm import ref as jref
from repro_torch.kernels.tdvmm import ops as tops
from repro_torch.kernels.tdvmm import ref as tref
from repro_torch.kernels.tdvmm import tdvmm as tk


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


def _operands(ex, e, m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    lead_x = () if ex is None else (ex,)
    lead_w = () if e is None else (e,)
    xq = rng.integers(-63, 64, lead_x + (m, k)).astype(np.int8)
    wq = rng.integers(-63, 64, lead_w + (k, n)).astype(np.int8)
    xs = rng.uniform(0.5, 2.0, lead_x + (m,)).astype(np.float32)
    ws = rng.uniform(0.5, 2.0, lead_w + (n,)).astype(np.float32)
    return xq, wq, xs, ws


def _zmax(xq, wq, gain):
    acc = np.matmul(xq.astype(np.int64), wq.astype(np.int64))
    z = np.abs(acc.astype(np.float32) * np.float32(gain))
    return z.max(axis=(-2, -1)) if acc.ndim == 3 else z.max()


def _both(xq, wq, xs, ws, out_window=None, **kw):
    """(port outputs by backend, the JAX package's jnp output)."""
    ow_j = None if out_window is None else jnp.asarray(out_window)
    yj = np.asarray(jops.tdvmm_matmul(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(xs), jnp.asarray(ws),
        backend="jnp", out_window=ow_j, **kw))
    outs = {}
    for backend, fused in (("jnp", True), ("auto", True), ("auto", False)):
        ow_t = None if out_window is None else torch.from_numpy(
            np.asarray(out_window, np.float32))
        outs[(backend, fused)] = tops.tdvmm_matmul(
            torch.from_numpy(xq), torch.from_numpy(wq), torch.from_numpy(xs),
            torch.from_numpy(ws), backend=backend, fused_calibration=fused,
            out_window=ow_t, **kw).numpy()
    return outs, yj


GAIN = 1.0 / (63.0 * 63.0 * 2.0 * 130)

# name: (x batch, w batch, M, K, N, readout)
CASES = {
    "2d_no_readout": (None, None, 3, 130, 200, "none"),
    "2d_fixed_window": (None, None, 3, 130, 200, "fixed"),
    "2d_runtime_window": (None, None, 3, 130, 200, "runtime"),
    "2d_data_calibrated": (None, None, 3, 130, 200, "data"),
    "batched_no_readout": (3, 3, 5, 130, 70, "none"),
    "batched_expert_windows": (3, 3, 5, 130, 70, "tuple"),
    "batched_runtime_expert_windows": (3, 3, 5, 130, 70, "runtime"),
    "batched_data_calibrated": (3, 3, 5, 130, 70, "data"),
    "shared_x_fixed_window": (1, 4, 6, 130, 96, "fixed"),
    "shared_x_data_calibrated": (1, 4, 6, 130, 96, "data"),
    "decode_row_runtime_window": (None, None, 1, 64, 128, "runtime"),
    "wide_tiles_data_calibrated": (None, None, 33, 130, 300, "data"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tdvmm_matmul_bitwise_vs_reference(case):
    ex, e, m, k, n, readout = CASES[case]
    xq, wq, xs, ws = _operands(ex, e, m, k, n)
    if ex == 1:                                  # shared-x: a 2-D x
        xq, xs = xq[0], xs[0]
    kw = {"gain": GAIN}
    zmax = _zmax(xq, wq, GAIN)
    if readout != "none":
        kw["out_bits"] = 6
    if readout == "fixed":
        kw["out_scale"] = float(np.float32(0.7 * np.max(zmax)))
    elif readout == "tuple":
        kw["out_scale"] = tuple(float(v) for v in 0.6 * zmax)
    elif readout == "runtime":
        kw["out_window"] = (0.8 * zmax).astype(np.float32)
    outs, yj = _both(xq, wq, xs, ws, **kw)
    for (backend, fused), y in outs.items():
        assert y.shape == yj.shape
        np.testing.assert_array_equal(
            y, yj, err_msg=f"{case}: backend={backend} fused={fused}")
    if ex == 1 or (readout in ("runtime", "tuple") and e is not None):
        return                  # the oracles take neither shared-x nor (E,)
    s = kw.get("out_scale")
    if readout == "runtime":
        s = float(kw["out_window"])
    yr_t = tref.tdvmm_matmul_ref(
        torch.from_numpy(xq), torch.from_numpy(wq), torch.from_numpy(xs),
        torch.from_numpy(ws), GAIN, kw.get("out_bits"), s).numpy()
    yr_j = np.asarray(jref.tdvmm_matmul_ref(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(xs), jnp.asarray(ws),
        GAIN, kw.get("out_bits"), s))
    np.testing.assert_array_equal(yr_t, yr_j)
    np.testing.assert_allclose(outs[("auto", True)], yr_t, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("shape", [(None, 3, 130, 200), (2, 5, 64, 70),
                                   (1, 6, 130, 96)])
def test_codes_matmul_bitwise(shape):
    e, m, k, n = shape
    xq, wq, _, _ = _operands(None if e is None else 1 if e == 1 else e,
                             e, m, k, n, seed=1)
    if e == 1:
        xq = xq[0]
        wq = np.concatenate([wq] * 3)            # shared-x against 3 tiles
    yj = np.asarray(jops.codes_matmul(jnp.asarray(xq), jnp.asarray(wq), "jnp"))
    for backend in ("jnp", "auto"):
        yt = tops.codes_matmul(torch.from_numpy(xq), torch.from_numpy(wq),
                               backend).numpy()
        np.testing.assert_array_equal(yt, yj)


@pytest.mark.parametrize("e,n,bn", [(1, 200, 64), (4, 128, 64), (2, 64, 128)])
def test_b2_plain_with_calib_slots(e, n, bn):
    """The B2 plain version with ``_calib_slots`` reproduces the unfused
    per-expert data-calibrated epilogue bitwise."""
    xq, wq, xs, ws = _operands(e, e, 7, 130, n, seed=2)
    slots, nslots = tops._calib_slots(e, n, bn, None)
    assert nslots == e and tuple(slots.shape) == (e, -(-n // min(bn, n)))
    y = tk.tdvmm_calibrated(
        torch.from_numpy(xq), torch.from_numpy(wq), torch.from_numpy(xs),
        torch.from_numpy(ws), slots, nslots, min(bn, n), GAIN, 6).numpy()
    yj = np.asarray(jops.tdvmm_matmul(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(xs), jnp.asarray(ws),
        gain=GAIN, out_bits=6, backend="jnp"))
    np.testing.assert_array_equal(y, yj)


def test_calib_slots_group_widths_match_reference():
    widths = (128, 256, 128)
    ids_t, n_t = tops._calib_slots(1, 512, 128, widths)
    ids_j, n_j = jops._calib_slots(1, 512, 128, widths)
    assert n_t == n_j == 3
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))


def test_empty_and_unported_modes():
    z = tops.tdvmm_matmul(torch.zeros((0, 8), dtype=torch.int8),
                          torch.ones((8, 5), dtype=torch.int8),
                          torch.ones(0), torch.ones(5), out_bits=6)
    assert tuple(z.shape) == (0, 5)
    # float32 codes (once refused) run, bitwise the reference's f32 path
    xf = np.arange(-4, 4, dtype=np.float32).reshape(1, 2, 4)
    wf = np.arange(12, dtype=np.float32).reshape(1, 4, 3) - 5
    y = tk.tdvmm_fused(torch.from_numpy(xf), torch.from_numpy(wf),
                       torch.ones(1, 2), torch.ones(1, 3))
    yj = jops.tdvmm_matmul(jnp.asarray(xf), jnp.asarray(wf), jnp.ones((1, 2)),
                           jnp.ones((1, 3)), backend="jnp", code_dtype="f32")
    np.testing.assert_array_equal(y.numpy(), np.asarray(yj))
    # mixed storages are refused
    with pytest.raises(ValueError, match="int8 or float32"):
        tk.tdvmm_fused(torch.zeros((1, 2, 4)),
                       torch.zeros((1, 4, 3), dtype=torch.int8),
                       torch.ones(1, 2), torch.ones(1, 3))
    # a ragged launch runs, and its member spans must tile the bank
    xq, wq, xs, ws = _operands(None, None, 2, 4, 3)
    y = tops.tdvmm_matmul(torch.from_numpy(xq), torch.from_numpy(wq),
                          torch.from_numpy(xs), torch.from_numpy(ws),
                          gain=0.01, out_bits=6, group_widths=(3,))
    yj = jops.tdvmm_matmul(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(xs),
                           jnp.asarray(ws), gain=0.01, out_bits=6,
                           backend="jnp", group_widths=(3,))
    np.testing.assert_array_equal(y.numpy(), np.asarray(yj))
    with pytest.raises(ValueError, match="sum to"):
        tops.tdvmm_matmul(torch.zeros((2, 4), dtype=torch.int8),
                          torch.zeros((4, 3), dtype=torch.int8),
                          torch.ones(2), torch.ones(3), group_widths=(2,))
    with pytest.raises(ValueError, match="out_window"):
        tops.tdvmm_matmul(torch.zeros((2, 4), dtype=torch.int8),
                          torch.zeros((4, 3), dtype=torch.int8),
                          torch.ones(2), torch.ones(3),
                          out_window=torch.ones(()))


# ---------------------------------------------------------------------------
# Ragged grouped launches (group_widths)
# ---------------------------------------------------------------------------
WIDTHS = (128, 256, 128, 128)        # lane-rounded member spans, N = 640


def test_member_window_cols_bitwise():
    vals = (0.013, 0.5, 1.0 / 3.0, 2.5e-4)
    n = sum(WIDTHS) + 128                       # a pad tail gets 1.0
    want = np.asarray(jops._member_window_cols(vals, WIDTHS, n))
    got = tops._member_window_cols(vals, WIDTHS, n, torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got is tops._member_window_cols(vals, WIDTHS, n,
                                           torch.device("cpu"))  # reused
    arr = np.asarray(vals, np.float32)
    want = np.asarray(jops._member_window_cols_arr(jnp.asarray(arr), WIDTHS,
                                                   n))
    got = tops._member_window_cols_arr(torch.from_numpy(arr), WIDTHS, n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("readout", ["none", "tuple", "runtime", "data"])
@pytest.mark.parametrize("m", [1, 6])
def test_tdvmm_matmul_ragged_bitwise_vs_reference(readout, m):
    """Every route (jnp; cuda-route plain versions of B1 with a per-column
    window, B2 with per-member slots, and B1 raw + epilogue) against the
    JAX package's jnp epilogue."""
    xq, wq, xs, ws = _operands(None, None, m, 130, sum(WIDTHS), seed=5)
    # member 2 integrates nothing: its window floors at 1e-9
    wq[:, 384:512] = 0
    kw = {"gain": GAIN, "group_widths": WIDTHS}
    if readout != "none":
        kw["out_bits"] = 6
    acc = np.matmul(xq.astype(np.int64), wq.astype(np.int64))
    z = np.abs(acc.astype(np.float32) * np.float32(GAIN))
    bounds = np.cumsum((0,) + WIDTHS)
    spans = np.array([max(z[:, a:b].max(), 1e-9)
                      for a, b in zip(bounds[:-1], bounds[1:])], np.float32)
    if readout == "tuple":
        kw["out_scale"] = tuple(float(v) for v in 0.75 * spans)
    elif readout == "runtime":
        kw["out_window"] = (0.85 * spans).astype(np.float32)
    outs, yj = _both(xq, wq, xs, ws, **kw)
    for (backend, fused), y in outs.items():
        assert y.shape == yj.shape == (m, sum(WIDTHS))
        np.testing.assert_array_equal(
            y, yj, err_msg=f"{readout}: backend={backend} fused={fused}")
    if readout == "data":
        # the per-member data window IS each member's standalone window
        off = 0
        for wd in WIDTHS:
            ys = tops.tdvmm_matmul(
                torch.from_numpy(xq), torch.from_numpy(wq[:, off:off + wd]),
                torch.from_numpy(xs), torch.from_numpy(ws[off:off + wd]),
                gain=GAIN, out_bits=6).numpy()
            np.testing.assert_array_equal(outs[("auto", True)][:, off:off + wd],
                                          ys)
            off += wd


def test_ragged_b2_slots_follow_members():
    """B2's slot map for a ragged launch: 64-column tiles, one slot per
    member, never a tile across two members."""
    slots, nslots = tops._calib_slots(1, sum(WIDTHS), tk.TILE_N, WIDTHS)
    assert nslots == len(WIDTHS)
    want = np.repeat(np.arange(len(WIDTHS)), np.asarray(WIDTHS) // tk.TILE_N)
    np.testing.assert_array_equal(slots.numpy()[0], want)


@pytest.mark.parametrize("bad", ["batched", "window_shape", "tuple_len"])
def test_ragged_argument_checks(bad):
    xq, wq, xs, ws = _operands(None, None, 2, 8, 256, seed=6)
    args = [torch.from_numpy(a) for a in (xq, wq, xs, ws)]
    kw = dict(out_bits=6, group_widths=(128, 128))
    if bad == "batched":
        args[1] = args[1][None].repeat(2, 1, 1)
        args[3] = args[3][None].repeat(2, 1)
        match = "2-D ragged"
    elif bad == "window_shape":
        kw["out_window"] = torch.ones(3)
        match = "grouped launch"
    else:
        kw["out_scale"] = (0.1, 0.2, 0.3)
        match = "member windows"
    with pytest.raises(ValueError, match=match):
        tops.tdvmm_matmul(*args, **kw)


# ---------------------------------------------------------------------------
# Float32 codes (p = 8) and int4 pairs (p <= 3)
# ---------------------------------------------------------------------------
# code ranges: 8-bit inputs x 4-bit weights (f32 codes), 3 x 3 bits (int4)
WIDE = {"f32": (255, 15), "int4": (7, 7)}


def _wide_operands(code_dtype, ex, e, m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    lx, lw = WIDE[code_dtype]
    dtype = np.float32 if code_dtype == "f32" else np.int8
    lead_x = () if ex is None else (ex,)
    lead_w = () if e is None else (e,)
    xq = rng.integers(-lx, lx + 1, lead_x + (m, k)).astype(dtype)
    wq = rng.integers(-lw, lw + 1, lead_w + (k, n)).astype(dtype)
    xs = rng.uniform(0.5, 2.0, lead_x + (m,)).astype(np.float32)
    ws = rng.uniform(0.5, 2.0, lead_w + (n,)).astype(np.float32)
    return xq, wq, xs, ws, 1.0 / (lx * lw * 2.0 * k)


# name: (x batch, w batch, M, K, N); odd K exercises the int4 pad nibble
WIDE_SHAPES = {"2d": (None, None, 3, 131, 200),
               "expert_grid": (4, 4, 5, 131, 70),
               "shared_x": (1, 3, 6, 64, 96)}


@pytest.mark.parametrize("readout", ["none", "fixed", "tuple", "runtime",
                                     "data"])
@pytest.mark.parametrize("shape", sorted(WIDE_SHAPES))
@pytest.mark.parametrize("code_dtype", ["f32", "int4"])
def test_tdvmm_matmul_wide_codes_bitwise(code_dtype, shape, readout):
    """Every route (jnp; the cuda route's plain versions of B1 fused, B2,
    and B1 raw + epilogue, int4 through pack_int4) against the JAX
    package's jnp path with the same ``code_dtype``.  A 2-D launch's
    "tuple" window is its one-entry (E,) form."""
    ex, e, m, k, n = WIDE_SHAPES[shape]
    xq, wq, xs, ws, gain = _wide_operands(code_dtype, ex, e, m, k, n)
    if ex == 1:                                  # shared-x: a 2-D x
        xq, xs = xq[0], xs[0]
    kw = {"gain": gain, "code_dtype": code_dtype}
    zmax = _zmax(xq.astype(np.int64), wq.astype(np.int64), gain)
    if readout != "none":
        kw["out_bits"] = 6
    if readout == "fixed":
        kw["out_scale"] = float(np.float32(0.7 * np.max(zmax)))
    elif readout == "tuple":
        kw["out_scale"] = tuple(float(v) for v in 0.6 * np.reshape(zmax, -1))
    elif readout == "runtime":
        kw["out_window"] = (0.8 * zmax).astype(np.float32)
    outs, yj = _both(xq, wq, xs, ws, **kw)
    for (backend, fused), y in outs.items():
        assert y.shape == yj.shape
        np.testing.assert_array_equal(
            y, yj, err_msg=f"{shape}: backend={backend} fused={fused}")


@pytest.mark.parametrize("code_dtype", ["f32", "int4"])
def test_codes_matmul_wide_codes_bitwise(code_dtype):
    xq, wq, _, _, _ = _wide_operands(code_dtype, 2, 2, 5, 33, 70, seed=3)
    yj = np.asarray(jops.codes_matmul(jnp.asarray(xq), jnp.asarray(wq), "jnp",
                                      code_dtype=code_dtype))
    for backend in ("jnp", "auto"):
        yt = tops.codes_matmul(torch.from_numpy(xq), torch.from_numpy(wq),
                               backend, code_dtype=code_dtype)
        assert yt.dtype == torch.float32
        np.testing.assert_array_equal(yt.numpy(), yj)


@pytest.mark.parametrize("code_dtype", ["f32", "int4"])
def test_b1_b2_plain_wide_codes_are_exact(code_dtype):
    """The wrappers' plain versions in the wide storages (what B1/B2 are
    held to on the card) against the exact integer accumulation: raw, fused
    with (E,) windows, and B2 with one slot per expert."""
    from repro_torch.core import quant
    xq, wq, xs, ws, gain = _wide_operands(code_dtype, 3, 3, 7, 131, 130,
                                          seed=4)
    exact = torch.from_numpy(np.matmul(xq.astype(np.int64),
                                       wq.astype(np.int64)).astype(np.int32))
    if code_dtype == "f32":
        xc, wc, i4 = torch.from_numpy(xq), torch.from_numpy(wq), None
    else:
        xc = quant.pack_int4(torch.from_numpy(xq), -1)
        wc = quant.pack_int4(torch.from_numpy(wq), -2)
        i4 = 131
    xs_t, ws_t = torch.from_numpy(xs), torch.from_numpy(ws)
    raw = tk.tdvmm_matmul_raw(xc, wc, i4)
    assert raw.dtype == (torch.float32 if code_dtype == "f32"
                         else torch.int32)
    np.testing.assert_array_equal(raw.numpy(), exact.numpy())
    win = torch.from_numpy((0.7 * _zmax(xq.astype(np.int64),
                                        wq.astype(np.int64), gain)
                            ).astype(np.float32))
    np.testing.assert_array_equal(
        tk.tdvmm_fused(xc, wc, xs_t, ws_t, gain, 6, win, i4).numpy(),
        tk.epilogue_plain(exact, xs_t, ws_t, gain, 6,
                          win.reshape(-1, 1, 1)).numpy())
    slots, nslots = tops._calib_slots(3, 130, tk.TILE_N, None)
    np.testing.assert_array_equal(
        tk.tdvmm_calibrated(xc, wc, xs_t, ws_t, slots, nslots, tk.TILE_N,
                            gain, 6, i4).numpy(),
        tops._epilogue(exact, xs_t, ws_t, gain, 6, None).numpy())
    with pytest.raises(ValueError, match="int4_k"):
        tk.tdvmm_matmul_raw(torch.from_numpy(xq).to(torch.int8),
                            torch.from_numpy(wq).to(torch.int8), 131)
