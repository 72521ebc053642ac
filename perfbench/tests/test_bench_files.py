"""Every data file parses, every name ``BENCHMARK.json`` gives resolves to
its file, and the file keeps to the benchmark's contract."""
import importlib
import json
import re

import pytest

from perfbench import harness, traffic

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = ("hidden", "intermediate", "latent", "state", "projection")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    doc = json.loads((harness.ROOT / cfg["file"]).read_text())
    assert doc["reduced"] == cfg["reduced"]
    assert cfg["file"].startswith("perfbench/configs/")
    for key in cfg["reduced"]:
        assert NAME.match(key)
        assert not key.endswith(("_dim", "_rank")), key
        assert not (key.endswith("_size") and any(w in key for w in WIDTHS)), key
    assert doc["source"] == cfg["source"]
    harness.port_config(doc["run"])          # the program takes it


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    c = harness.resolve(cell["name"], BENCH)
    importlib.import_module(f"perfbench.drivers.{c.mix['driver']}")
    assert cell["chips"] == 1
    assert len(cell["why"]) <= 200
    assert c.limits, cell["name"]
    for k, lim in c.limits.items():
        assert lim["lower"] < lim["limit"], (cell["name"], k)
        assert lim["upper"] is None or lim["limit"] < lim["upper"]
    e2e = [m for m in BENCH["end_to_end"]
           if "workloads" not in m or cell["name"] in m["workloads"]]
    assert any(m["name"] == "setup_s" for m in e2e) and len(e2e) >= 2
    assert harness.wanted(BENCH, cell["name"], True)


def test_metrics_resolve():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        mod, _ = harness.metric_reader(m["name"])
        assert callable(mod.read)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", ()):
            reports = e2e[m["moves"]].get("workloads")
            assert reports is None or w in reports, (m["name"], w)


def test_traffic_sizes_do_not_follow_the_seed():
    for name in ("engine-chat",):
        mix = json.loads((harness.BENCH / "traffic" / f"{name}.json")
                         .read_text())
        a = traffic.requests(mix, 1, 1000)
        b = traffic.requests(mix, 2**31 + 7, 1000)
        assert sorted(len(r["prompt"]) for r in a) == \
            sorted(len(r["prompt"]) for r in b)
        assert sorted(r["max_new"] for r in a) == \
            sorted(r["max_new"] for r in b)
        assert [len(r["prompt"]) for r in a] != \
            [len(r["prompt"]) for r in b]
