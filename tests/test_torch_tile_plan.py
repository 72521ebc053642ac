"""The Python around the tensor-core B1/B2 kernels: the CTA tile plan, the
f32-code width check, the 16-byte staging rule, B2's readout slots at the
64-column slot block (ragged ``ssm.in_proj`` members included), and the
plain versions at the edge of the float32 codes' exact envelope."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tdvmm import ops as jops
from repro_torch.configs.base import TDVMMLayerConfig
from repro_torch.core import layers
from repro_torch.kernels.tdvmm import ops as tops
from repro_torch.kernels.tdvmm import tdvmm as tk


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("m,name,rows,cols", [
    (1, "small", 16, 64), (16, "small", 16, 64), (17, "small", 16, 64),
    (128, "small", 16, 64), (129, "small", 16, 64), (256, "small", 16, 64),
    (257, "large", 128, 128), (2049, "large", 128, 128)])
def test_plan_tile_by_rows(m, name, rows, cols):
    tile = tk.plan_tile(m)
    assert (tile.name, tile.rows, tile.cols) == (name, rows, cols)
    assert tk.TILES[tile.index] is tile
    # every tile is whole 64-column readout-slot blocks wide
    assert tile.cols % tk.TILE_N == 0


@pytest.mark.parametrize("max_code", [255, 256, 63, 0])
def test_code_width_accepts_bf16_exact_codes(max_code):
    # p = 8 inputs x 4-bit weights: max(255, 15) = 255
    assert tk.check_code_width("f32", max_code) == "f32"


@pytest.mark.parametrize("max_code,bits", [(257, 9), (511, 9), (1023, 10),
                                           (2047, 11)])
def test_code_width_raises_for_wide_f32_codes(max_code, bits):
    # p = 9-11 codes take the 3xTF32 storage, which holds |2047| exactly;
    # the same width four bits wider is past TF32's 11 bits and raises
    assert tk.check_code_width("f32", max_code) == "f32x3"
    wide = max_code * 16 + 15
    with pytest.raises(ValueError, match=f"{bits + 4}-bit code width"):
        tk.check_code_width("f32", wide)


def test_code_width_needs_max_code_for_f32_only():
    with pytest.raises(ValueError, match="need max_code"):
        tk.check_code_width("f32", None)
    for codes in ("int8", "int4"):
        tk.check_code_width(codes, None)
        tk.check_code_width(codes, 10_000)


@pytest.mark.parametrize("site", ["td_matmul", "td_expert_matmul",
                                  "td_grouped_matmul"])
def test_layers_pass_max_code(site, monkeypatch):
    """The layer hands the kernels the largest |code| of its two bit widths
    (8-bit inputs x 4-bit weights: 255)."""
    seen = []
    real = tops.tdvmm_matmul

    def spy(*args, **kw):
        seen.append(kw.get("max_code"))
        return real(*args, **kw)
    monkeypatch.setattr(tops, "tdvmm_matmul", spy)
    cfg = TDVMMLayerConfig(enabled=True, bits=8, weight_bits=4,
                           backend="auto")
    rng = np.random.default_rng(0)
    if site == "td_expert_matmul":
        x = torch.from_numpy(rng.normal(size=(2, 3, 16)).astype(np.float32))
        w = torch.from_numpy(rng.normal(size=(2, 16, 8)).astype(np.float32))
        layers.td_expert_matmul(x, w, cfg)
    else:
        x = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32))
        w = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
        if site == "td_matmul":
            layers.td_matmul(x, w, cfg)
        else:
            layers.td_grouped_matmul(x, (w, w), cfg)
    assert seen == [255]


def test_vec_rule_is_sixteen_bytes():
    base = torch.zeros(4096 + 1, dtype=torch.int8)
    aligned = base[:4096]
    assert aligned.data_ptr() % 16 == 0
    assert tk._vec(aligned, 64) == 1
    assert tk._vec(aligned, 131) == 0             # ragged row
    assert tk._vec(aligned, 68) == 0              # 4-byte, not 16-byte rows
    assert tk._vec(base[1:], 64) == 0             # unaligned base
    g = tk.Launch(e=1, m=2, k=64, n=70, shared_x=False, codes="f32")
    x = torch.zeros((1, 2, 64), dtype=torch.float32)
    w = torch.zeros((1, 64, 70), dtype=torch.float32)
    assert tk._vecs(x, w, g) == (1, 0)            # 280-byte rows of w


SSM_WIDTHS = (4096, 4096, 128, 128, 128)


def test_calib_slots_ssm_members_at_slot_blocks():
    """mamba2's ssm.in_proj: five member spans, each a whole number of
    64-column slot blocks, one slot per member; no 128-column CTA tile of
    the large tile straddles two members."""
    n = sum(SSM_WIDTHS)
    slots, nslots = tops._calib_slots(1, n, tk.TILE_N, SSM_WIDTHS)
    assert nslots == 5 and tuple(slots.shape) == (1, n // tk.TILE_N)
    want = np.repeat(np.arange(5), np.asarray(SSM_WIDTHS) // tk.TILE_N)
    np.testing.assert_array_equal(slots.numpy()[0], want)
    cols = tk.TILES[-1].cols
    per_tile = slots.numpy()[0].reshape(-1, cols // tk.TILE_N)
    assert (per_tile == per_tile[:, :1]).all()


def test_b2_plain_ssm_member_slots_match_reference():
    """B2's plain version at the 64-column slot block with the five ragged
    member slots is bitwise the JAX package's per-member data-calibrated
    readout."""
    rng = np.random.default_rng(7)
    n, m, k = sum(SSM_WIDTHS), 3, 24
    xq = rng.integers(-63, 64, (m, k)).astype(np.int8)
    wq = rng.integers(-63, 64, (k, n)).astype(np.int8)
    # member spans of very different magnitude, so each slot's window differs
    wq[:, 4096:8192] //= 8
    xs = rng.uniform(0.5, 2.0, m).astype(np.float32)
    ws = rng.uniform(0.5, 2.0, n).astype(np.float32)
    gain = 1.0 / (63.0 * 63.0 * 2.0 * k)
    slots, nslots = tops._calib_slots(1, n, tk.TILE_N, SSM_WIDTHS)
    y = tk.tdvmm_calibrated(
        torch.from_numpy(xq)[None], torch.from_numpy(wq)[None],
        torch.from_numpy(xs)[None], torch.from_numpy(ws)[None], slots,
        nslots, tk.TILE_N, gain, 6).numpy()[0]
    yj = np.asarray(jops.tdvmm_matmul(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(xs), jnp.asarray(ws),
        gain=gain, out_bits=6, backend="jnp", group_widths=SSM_WIDTHS))
    np.testing.assert_array_equal(y, yj)


@pytest.mark.parametrize("k,acc", [(4096, 15_667_200), (4386, 16_776_450)])
@pytest.mark.parametrize("fill", ["max", "alt_rows"])
def test_b1_b2_plain_f32_envelope_edge_is_exact(k, acc, fill):
    """x = +255 and w = +15 everywhere (every product of one sign), at
    moe_mixed's K 4096 and at K 4386, 766 below 2^24, which the layer still
    accepts without a warning; and with x's sign alternating by row.  The
    plain versions B1/B2 are held to on the card give the exact sums."""
    cfg = TDVMMLayerConfig(enabled=True, bits=8, weight_bits=4)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert layers._plan_code_dtype(cfg, k, False) == "f32"
    assert 255 * 15 * k == acc < 1 << 24
    e, m, n = 2, 3, 5
    x = np.full((e, m, k), 255.0, np.float32)
    if fill == "alt_rows":
        x[:, 1::2] = -255.0
    w = np.full((e, k, n), 15.0, np.float32)
    exact = np.matmul(x.astype(np.int64), w.astype(np.int64))
    assert np.abs(exact).max() == acc
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    raw = tk.tdvmm_matmul_raw(xt, wt, max_code=255)
    assert raw.dtype == torch.float32
    np.testing.assert_array_equal(raw.numpy(), exact.astype(np.float32))
    rng = np.random.default_rng(k)
    xs = torch.from_numpy(rng.uniform(0.5, 2.0, (e, m)).astype(np.float32))
    ws = torch.from_numpy(rng.uniform(0.5, 2.0, (e, n)).astype(np.float32))
    gain = 1.0 / (255.0 * 15.0 * 2.0 * k)
    exact_t = torch.from_numpy(exact.astype(np.int32))
    win = torch.full((e,), 0.3, dtype=torch.float32)
    np.testing.assert_array_equal(
        tk.tdvmm_fused(xt, wt, xs, ws, gain, 6, win, max_code=255).numpy(),
        tk.epilogue_plain(exact_t, xs, ws, gain, 6,
                          win.reshape(-1, 1, 1)).numpy())
    slots, nslots = tops._calib_slots(e, n, tk.TILE_N, None)
    np.testing.assert_array_equal(
        tk.tdvmm_calibrated(xt, wt, xs, ws, slots, nslots, min(tk.TILE_N, n),
                            gain, 6, max_code=255).numpy(),
        tops._epilogue(exact_t, xs, ws, gain, 6, None).numpy())
