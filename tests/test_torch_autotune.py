"""The TD-VMM tile autotuner: the per-shape table (``autotune_table.py``),
its lookups in ``tdvmm``, ``ops.plan_kernel`` and its report, the layers'
keys against the JAX package's, and the sweep's work list and table text
(``launch/autotune_tdvmm``).  The table is measured on the card; here the
plain versions ignore the tile, so these tests hold the Python around it."""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as jarchs
from repro.configs import plan as jplan
from repro.core import layers as jlayers
from repro.kernels.tdvmm import ops as jops
from repro_torch.configs import archs
from repro_torch.configs import plan as tplan
from repro_torch.configs.base import TDVMMLayerConfig
from repro_torch.core import layers
from repro_torch.kernels.tdvmm import autotune_table
from repro_torch.kernels.tdvmm import ops
from repro_torch.kernels.tdvmm import tdvmm as tk
from repro_torch.launch import autotune_tdvmm as at

JLayer = jlayers.TDVMMLayerConfig


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


def _clear():
    tk._read_table.cache_clear()
    tk._lookup.cache_clear()
    ops._plan.cache_clear()


@pytest.fixture
def table(monkeypatch):
    """Swap the committed table for one the test writes; caches cleared
    before and after."""
    def use(entries):
        monkeypatch.setattr(autotune_table, "HOPPER_TABLE", dict(entries))
        _clear()
    yield use
    monkeypatch.undo()
    _clear()


# --------------------------------------------------------------------------
# Lookups
# --------------------------------------------------------------------------
@pytest.mark.parametrize("key", sorted(autotune_table.HOPPER_TABLE))
def test_lookup_returns_the_committed_tile(key):
    tile, hit = tk.autotune_lookup(*key)
    assert hit and tile.name == autotune_table.HOPPER_TABLE[key]
    assert tk.autotune_blocks(*key) is tile


@pytest.mark.parametrize("m", [1, 3, 256, 257, 4097])
def test_lookup_miss_takes_plan_tile(m):
    # K 7 x N 11 is no shape of any arch
    for dtype in ("int8", "int4", "f32", "float32", "f32x3", torch.int8,
                  torch.float32):
        assert tk.autotune_lookup(m, 7, 11, dtype) == (tk.plan_tile(m), False)


def test_table_entry_overrides_plan_tile(table):
    table({(4, 1024, 2816, "int8"): "large", (512, 64, 64, "f32x3"): "small"})
    assert tk.autotune_lookup(4, 1024, 2816, "int8") == (tk.TILES[1], True)
    assert tk.autotune_lookup(512, 64, 64, "f32x3") == (tk.TILES[0], True)
    # the storage is part of the key: "f32" is the table's "float32"
    assert tk.autotune_lookup(4, 1024, 2816, "f32") == (tk.TILES[0], False)
    assert tk.autotune_lookup(4, 1024, 2816, "int8", "plain")[1]
    assert tk.autotune_lookup(4, 1024, 2816, "int8", "sm_90a")[1]


@pytest.mark.parametrize("entry,match", [
    ({(4, 8, 8, "int8"): "medium"}, "unknown tile 'medium'"),
    ({(4, 8, 8, "bf16"): "small"}, "storage"),
    ({(0, 8, 8, "int8"): "small"}, "positive"),
])
def test_a_bad_entry_raises_when_the_table_is_read(table, entry, match):
    table(entry)
    with pytest.raises(ValueError, match=match):
        tk.autotune_table()
    with pytest.raises(ValueError, match=match):
        tk.autotune_lookup(4, 8, 8, "int8")


def test_lookup_refuses_unknown_names():
    with pytest.raises(ValueError, match="platform"):
        tk.autotune_table("mosaic")
    with pytest.raises(ValueError, match="code storage"):
        tk.autotune_lookup(4, 8, 8, "bf16")


def test_committed_entries_name_whole_slot_block_tiles():
    names = {t.name: t for t in tk.TILES}
    for key, name in autotune_table.HOPPER_TABLE.items():
        m, k, n, dtype = key
        assert dtype in tk.DTYPE_NAMES and min(m, k, n) > 0, key
        # B2 folds max|z| per 64-column slot block of its CTA tile
        assert names[name].cols % tk.TILE_N == 0, key
    assert tk.autotune_table() == {
        key: names[v] for key, v in autotune_table.HOPPER_TABLE.items()}


def test_launch_key_and_tile_of_a_wrapper_call(table):
    table({(64, 100, 200, "float32"): "large"})
    g = tk.Launch(1, 64, 100, 200, False, "f32")
    assert tk._tile(g, None, None) == ((64, 100, 200, "float32"),
                                       tk.TILES[1])
    # the caller's plan names the storage and may carry the tile
    assert tk._tile(g, "f32x3", None) == ((64, 100, 200, "f32x3"),
                                          tk.TILES[0])
    assert tk._tile(g, None, tk.TILES[0])[1] is tk.TILES[0]
    with pytest.raises(ValueError, match="tile"):
        tk._tile(g, None, tk.Tile(2, "huge", 256, 256))


def test_platform_follows_the_codes_device():
    assert tk.autotune_platform("cpu") == "plain"
    assert tk.autotune_platform(torch.device("cuda", 0)) == "sm_90a"
    assert tk.autotune_platform() == ("sm_90a" if torch.cuda.is_available()
                                      else "plain")


# --------------------------------------------------------------------------
# plan_kernel and its report
# --------------------------------------------------------------------------
def test_plan_kernel_logs_each_miss_once(monkeypatch, caplog):
    monkeypatch.setattr(ops, "_AUTOTUNE_WARNED", set())
    ops.reset_autotune_report()
    with caplog.at_level(logging.WARNING, logger=ops.__name__):
        for _ in range(3):
            kp = ops.plan_kernel("auto", 3, 7, 11, "int8", "cpu")
        ops.plan_kernel("jnp", 300, 7, 11, "f32", "cpu")
    misses = [r for r in caplog.records if "autotune miss" in r.message]
    assert [r.levelno for r in misses] == [logging.WARNING] * 2
    assert "(3, 7, 11, int8)" in misses[0].getMessage()
    assert kp == ops.KernelPlan("cuda", tk.TILES[0], "int8", False, "plain")
    rep = ops.autotune_report()
    assert set(rep) == {"platform", "entries", "misses"}
    assert rep["entries"] == {
        "3x7x11:int8": {"tile": "small", "hit": False, "platform": "plain"},
        "300x7x11:float32": {"tile": "large", "hit": False,
                             "platform": "plain"}}
    assert rep["misses"] == ["300x7x11:float32", "3x7x11:int8"]
    ops.reset_autotune_report()
    assert ops.autotune_report()["entries"] == {}


def test_plan_kernel_records_hits_on_the_card_platform(table):
    table({(4, 1024, 2816, "int8"): "large"})
    ops.reset_autotune_report()
    kp = ops.plan_kernel("auto", 4, 1024, 2816, "int8",
                         torch.device("cuda", 0))
    assert (kp.tile, kp.autotune_hit, kp.platform) == (tk.TILES[1], True,
                                                       "sm_90a")
    rep = ops.autotune_report("sm_90a")
    assert rep == {"platform": "sm_90a", "misses": [], "entries": {
        "4x1024x2816:int8": {"tile": "large", "hit": True,
                             "platform": "sm_90a"}}}
    ops.reset_autotune_report()


def _site_calls(mod, cfg, arr, x, w, xe, we, ws):
    mod.td_matmul(arr(x), arr(w), cfg)
    mod.td_expert_matmul(arr(xe), arr(we), cfg)
    mod.td_grouped_matmul(arr(x), [arr(v) for v in ws], cfg)
    mod.calibrate_out_scale(arr(x), arr(w), cfg)


@pytest.mark.parametrize("bits", [6, 3, 8])
def test_layers_record_the_reference_keys(bits):
    """td_matmul, td_expert_matmul (keyed by its per-expert rows C, E not
    in the key), td_grouped_matmul (the lane-rounded concat width) and
    calibrate_out_scale record the JAX package's (M, K, N, dtype) keys,
    int8, int4 and "float32" alike."""
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    w = rng.standard_normal((24, 40)).astype(np.float32)
    xe = rng.standard_normal((3, 7, 24)).astype(np.float32)
    we = rng.standard_normal((3, 24, 16)).astype(np.float32)
    ws = [rng.standard_normal((24, n)).astype(np.float32) for n in (40, 130)]
    kw = dict(enabled=True, bits=bits, weight_bits=bits)
    jops.reset_autotune_report()
    _site_calls(jlayers, JLayer(backend="jnp", **kw), jnp.asarray, x, w, xe,
                we, ws)
    ops.reset_autotune_report()
    _site_calls(layers, TDVMMLayerConfig(**kw), torch.from_numpy, x, w, xe,
                we, ws)
    mine = ops.autotune_report()["entries"]
    ref = jops.autotune_report()["entries"]
    assert set(mine) == set(ref) and len(mine) == 3
    dtype = {6: "int8", 3: "int4", 8: "float32"}[bits]
    assert set(mine) == {f"10x24x40:{dtype}", f"7x24x16:{dtype}",
                         f"10x24x384:{dtype}"}
    ops.reset_autotune_report()


@pytest.mark.parametrize("site", ["td_matmul", "td_expert_matmul",
                                  "td_grouped_matmul"])
def test_layers_launch_at_the_planned_tile(site, table, monkeypatch):
    """A table entry that differs from plan_tile reaches the kernel call."""
    table({(10, 24, 40, "int8"): "large", (7, 24, 16, "int8"): "large",
           (10, 24, 256, "int8"): "large"})
    seen = []
    real = ops.tdvmm_matmul

    def spy(*args, **kw):
        seen.append(kw.get("tile"))
        return real(*args, **kw)
    monkeypatch.setattr(ops, "tdvmm_matmul", spy)
    rng = np.random.default_rng(0)
    cfg = TDVMMLayerConfig(enabled=True)
    t = torch.from_numpy
    if site == "td_matmul":
        layers.td_matmul(t(rng.standard_normal((2, 5, 24), np.float32)),
                         t(rng.standard_normal((24, 40), np.float32)), cfg)
    elif site == "td_expert_matmul":
        layers.td_expert_matmul(
            t(rng.standard_normal((3, 7, 24), np.float32)),
            t(rng.standard_normal((3, 24, 16), np.float32)), cfg)
    else:
        layers.td_grouped_matmul(
            t(rng.standard_normal((10, 24), np.float32)),
            [t(rng.standard_normal((24, n), np.float32)) for n in (40, 100)],
            cfg)
    assert seen == [tk.TILES[1]]


# --------------------------------------------------------------------------
# The sweep's work list and table text
# --------------------------------------------------------------------------
def _miss(shapes):
    return [s for s in shapes if not tk.autotune_lookup(*s)[1]]


def test_table_covers_the_reference_bench_shapes():
    assert len(at.BENCH_SHAPES) == 14
    assert _miss(at.BENCH_SHAPES) == []


@pytest.mark.parametrize("arch", sorted(archs.ARCHS))
def test_table_covers_every_archs_launch_shapes(arch):
    mine = archs.get_config(arch)
    shapes = at.collect_shapes([arch], 512)
    planned = [(m, k, n, tk.dtype_name(d)) for m, k, n, d in
               jplan.plan_launch_shapes(jarchs.get_config(arch), 512)]
    # the JAX package's work list for the arch, and the port's the same
    assert planned == [(m, k, n, tk.dtype_name(d)) for m, k, n, d in
                       tplan.plan_launch_shapes(mine, 512)]
    assert set(planned) <= set(shapes)
    assert _miss(planned) == []


def test_table_covers_the_main_paths_serving_shapes():
    shapes = at.serving_shapes()
    assert shapes == [(m, k, n, "int8") for m in at.SERVING_ROWS
                      for k, n in ((1024, 2816), (2816, 1024))]
    assert _miss(shapes) == []


def test_the_whole_work_list_is_the_reference_lists_and_serving():
    shapes = at.collect_shapes(sorted(archs.ARCHS), 512)
    assert len(shapes) == len(set(shapes)) == 14 + 42 + 8
    assert _miss(shapes) == []


def test_render_reproduces_the_committed_file():
    assert at.render(at.current_entries()) == at.TABLE_PATH.read_text()


def test_render_sorts_its_entries():
    entries = {(512, 8, 8, "int8"): "large", (4, 8, 8, "int8"): "small",
               (4, 8, 8, "float32"): "small"}
    text = at.render(entries)
    assert text == at.render(dict(reversed(list(entries.items()))))
    ns = {}
    exec(text, ns)
    assert ns["HOPPER_TABLE"] == entries
    assert list(ns["HOPPER_TABLE"]) == sorted(entries)


def _fake_sweep(shapes, measure_limit, seed=0, log=print):
    return [dict(key=s, pick="large", planned=tk.plan_tile(s[0]).name,
                 median={"small": 2.0, "large": 1.0}, spread=0.1,
                 within_spread=False) for s in shapes]


def test_dry_run_prints_and_writes_nothing(monkeypatch, tmp_path, capsys):
    path = tmp_path / "autotune_table.py"
    path.write_text("committed")
    monkeypatch.setattr(at, "TABLE_PATH", path)
    monkeypatch.setattr(at, "sweep", _fake_sweep)
    monkeypatch.setattr(at, "card_line", lambda: "a card, 700.00 W")
    assert at.main(["--archs", "qwen1.5-0.5b", "--dry-run"]) == 0
    assert path.read_text() == "committed"
    out = capsys.readouterr().out
    want = at.render({**at.current_entries(), **{
        s: "large" for s in at.collect_shapes(["qwen1.5-0.5b"], 512)}})
    assert want in out and "where the pick differs from plan_tile" in out
    # without --dry-run the same text is written
    assert at.main(["--archs", "qwen1.5-0.5b"]) == 0
    assert path.read_text() == want


def test_sweep_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        at.sweep(at.serving_shapes(), 1e13)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        at.main(["--archs", "qwen1.5-0.5b", "--dry-run"])


def test_summary_counts_the_picks_that_differ_from_plan_tile():
    rows = [dict(key=(4, 8, 8, "int8"), pick="large", planned="small",
                 median={"small": 2.0, "large": 1.0}, spread=0.1,
                 within_spread=False),
            dict(key=(512, 8, 8, "float32"), pick="large", planned="large",
                 median={"small": 2.0, "large": 1.9}, spread=0.2,
                 within_spread=False, f32x3_equal=True),
            dict(key=(9, 8, 8, "int8"), pick=None)]
    lines = at.summary(rows)
    assert lines[0] == ("[autotune] 3 shapes, 2 timed, 1 where the pick "
                        "differs from plan_tile, 0 kept at plan_tile within "
                        "the spread")
    assert "4x8x8:int8 large 1.00000 ms, plan_tile small 2.00000 ms" \
        in lines[2]
    assert lines[-1] == "[autotune] f32x3: tiles bitwise at 1 of 1 float32 " \
        "shapes"
    assert at.measured_entries(rows) == {(4, 8, 8, "int8"): "large",
                                         (512, 8, 8, "float32"): "large"}
