"""The last surface of the JAX package with a counterpart in the port, on the
CPU: the serve CLI's ``--plan-report`` (the JAX package's ``describe()``
text, on the engine path and with ``--static``), the roofline report on the
dry run's JSON (``launch/roofline_report``: the generator table
byte-equal to ``scripts/gen_roofline_md.py``'s, the compact table, the
per-cell strings of ``benchmarks/roofline_report.py``), and the two
examples (``launch/quickstart``, ``launch/serve_lm``) fed the JAX examples'
own draws."""
import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TDVMMPlan as JPlan
from repro.configs import get_config as jget
from repro.configs import smoke as jsmoke
from repro.configs import tdvmm_rule as jrule
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import TDVMMLayerConfig as JLayer
from repro.core import currents as jcur
from repro.core import encoding as jenc
from repro.core import quant as jquant
from repro.core import tdcore as jtd
from repro.core.constants import TDVMMSpec as JSpec
from repro.core.layers import td_matmul as jtd_matmul
from repro.models import model as jmodel
from repro_torch import convert
from repro_torch.core import quant as tquant
from repro_torch.launch import quickstart, roofline_report, serve, serve_lm

ROOT = Path(__file__).resolve().parents[1]
# steps 1-5 of the quickstart: the encoding, the programmed currents and
# the closed forms, float32 on both sides in other evaluation orders,
# relative to max|ref|
STEP_RTOL = 1e-6
# the simulated circuit (steps 3-4 and the time-domain MLP): the port's
# bisection against the reference's exact crossing solve, decoded outputs
# and crossing times / T absolute, the bound of tests/test_torch_tdcore.py
# (the bisection's last bracket, 2^-23 of T, plus float32 rounding)
TD_ATOL = 2.5e-6
# calibrated windows, relative
WINDOW_RTOL = 1e-6
# prefill logits relative to max|logit| (the model-level bound of
# tests/test_torch_model.py)
LOGIT_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quickstart_jax_config(backend="jnp"):
    """``examples/quickstart.py``'s model and plan, as the example builds
    them."""
    return JModelConfig(
        name="quickstart-lm", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
        vocab_pad_multiple=16, dtype="float32", remat_policy="none",
        tdvmm_plan=JPlan(rules=(
            jrule("*", enabled=True, backend=backend),
            jrule("attn.qkv", bits=5),
            jrule("ffn.in", chain=True),
            jrule("head", bits=7),
        )))


# ---------------------------------------------------------------------------
# --plan-report
# ---------------------------------------------------------------------------
CLI_PLANS = {"none": [], "ffn": ["--tdvmm", "ffn.*"],
             "ffn_chained": ["--tdvmm", "ffn.*", "--chain"],
             "quickstart": []}


def _reference_describe(plan: str) -> str:
    if plan == "quickstart":
        return _quickstart_jax_config().resolved_tdvmm_plan.describe()
    cfg = jsmoke(jget("qwen1.5-0.5b"))
    rules = []
    if plan != "none":
        rules.append(jrule("ffn.*", enabled=True))
    if plan == "ffn_chained":
        rules.append(jrule("ffn.in", chain=True))
    if rules:
        cfg = cfg.replace(tdvmm_plan=JPlan(rules=tuple(rules)))
    return cfg.resolved_tdvmm_plan.describe()


@pytest.mark.parametrize("path", ["engine", "static"])
@pytest.mark.parametrize("plan", list(CLI_PLANS))
def test_plan_report_prints_the_reference_describe(plan, path, monkeypatch,
                                                   capsys):
    if plan == "quickstart":
        # the CLI's flags cannot state this plan: serve quickstart's model
        monkeypatch.setattr(serve, "smoke_cfg",
                            lambda cfg: quickstart.lm_config("cpu"))
    argv = ["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
            "--plan-report", "--prompt-len", "4", "--gen", "2",
            *CLI_PLANS[plan]]
    argv += (["--static", "--batch", "1"] if path == "static" else
             ["--requests", "1", "--slots", "1", "--calibrate"])
    serve.main(argv)
    out = capsys.readouterr().out
    want = "[serve] TD-VMM plan:\n" + _reference_describe(plan) + "\n"
    assert want in out, out
    assert out.count("[serve] TD-VMM plan:") == 1


def test_serve_static_plan_report_is_off_by_default(capsys):
    cfg = quickstart.lm_config("cpu")
    serve.serve_static(cfg, 1, 4, 2, device="cpu")
    assert "TD-VMM plan" not in capsys.readouterr().out
    serve.serve_static(cfg, 1, 4, 2, device="cpu", plan_report=True)
    assert capsys.readouterr().out == (
        "[serve] TD-VMM plan:\n"
        + _quickstart_jax_config().resolved_tdvmm_plan.describe() + "\n")


# ---------------------------------------------------------------------------
# The roofline report
# ---------------------------------------------------------------------------
def _ok_cell(arch, shape, pod, dominant, bound, peak_gb, fits=True):
    """A cell with the keys ``launch/dryrun.py`` writes."""
    terms = {"compute": bound / 7.0, "memory": bound / 3.0,
             "collective": bound / 2.0}
    terms[dominant] = bound
    return {
        "status": "ok", "arch": arch, "shape": shape,
        "mesh": [2, 16, 16] if pod == "pod2" else [16, 16],
        "mesh_axes": ["pod", "data", "model"] if pod == "pod2"
        else ["data", "model"], "chips": 512 if pod == "pod2" else 256,
        "rank": 0, "layers": 2, "lower_s": 0.1, "compile_s": 1.2,
        "params": 123456, "active_params": 123456,
        "memory_analysis": {
            "generated_code_size_in_bytes": None,
            "argument_size_in_bytes": int(1.5 * 2**30),
            "output_size_in_bytes": 10,
            "temp_size_in_bytes": int(peak_gb * 1e9 - 1.5 * 2**30),
            "alias_size_in_bytes": 0},
        "peak_bytes": int(peak_gb * 1e9), "fits_h100": fits,
        "cost_analysis_raw": {"flops": 1e15, "bytes accessed": 1e13},
        "flops_by_class": {"bf16": 1e15, "int8": 0.0, "f32": 0.0},
        "collective_bytes": {"all-reduce": 1e10, "total": 1e10},
        "collective_bytes_by_link": {"nvlink": 0.0, "ib": 1e10},
        "kernel_launches": {}, "step": {"accum": 1},
        "roofline": {
            "chips": 256, "flops_per_device": 1e15, "bytes_per_device": 1e13,
            "coll_bytes_per_device": 1e10, "model_flops": 2e17,
            "t_compute_s": terms["compute"], "t_memory_s": terms["memory"],
            "t_collective_s": terms["collective"], "dominant": dominant,
            "step_time_lower_bound_s": bound,
            "mfu_at_bound": 0.00734, "model_to_hlo_flops": 0.5557},
        "wall_s": 3.0}


SKIPPED = {"status": "skipped",
           "reason": "pure full-attention arch; 524k dense KV cache is out "
                     "of scope per DESIGN.md §5", "wall_s": 0.0}


def _error_cell(arch, shape, pod):
    return {"status": "error", "arch": arch, "shape": shape,
            "multi_pod": pod == "pod2", "error": "boom",
            "traceback": "Traceback ...", "wall_s": 0.5}


def _write_cells(art: Path, error: bool) -> None:
    """ok cells of every dominant term, one over the card's memory, skipped
    cells, a missing cell at pod2, and (``error``) an error cell."""
    art.mkdir(parents=True, exist_ok=True)
    cells = {   # (dominant term, bound at pod1, peak GB at pod1, pod2)
        ("yi-34b", "train_4k"): ("collective", 382.1, 46.8, 37.4),
        ("yi-34b", "prefill_32k"): ("collective", 1164.2, 14.7, 9.5),
        ("mixtral-8x7b", "decode_32k"): ("memory", 0.000077, 6.1, 6.1),
        ("kimi-k2-1t-a32b", "train_4k"): ("compute", 197.4, 158.2, 53.1),
        ("zamba2-2.7b", "long_500k"): ("memory", 0.000273, 0.5, None),
    }
    for pod, scale in (("pod1", 1.0), ("pod2", 0.5)):
        for (arch, shape), (dom, bound, gb1, gb2) in cells.items():
            gb = gb1 if pod == "pod1" else gb2
            if gb is None:
                continue                                  # missing
            d = _ok_cell(arch, shape, pod, dom, bound * scale, gb,
                         fits=gb < 80)
            (art / f"{arch}__{shape}__{pod}.json").write_text(
                json.dumps(d, indent=2))
        (art / f"yi-34b__long_500k__{pod}.json").write_text(
            json.dumps(SKIPPED))
        if error:
            (art / f"qwen1.5-0.5b__train_4k__{pod}.json").write_text(
                json.dumps(_error_cell("qwen1.5-0.5b", "train_4k", pod)))


def _reference_table(art: Path, pod: str, monkeypatch) -> str:
    gen = _load(ROOT / "scripts" / "gen_roofline_md.py", "gen_roofline_md")
    monkeypatch.setattr(gen, "ART", art)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        gen.main(pod)
    return buf.getvalue()


@pytest.mark.parametrize("pod", ["pod1", "pod2"])
def test_generator_table_is_byte_equal_to_the_reference(pod, tmp_path,
                                                        monkeypatch):
    _write_cells(tmp_path, error=False)
    got = roofline_report.generator_table(tmp_path, pod) + "\n"
    assert got == _reference_table(tmp_path, pod, monkeypatch)
    assert "| skip |" in got and "| missing |" in got
    assert ("| zamba2-2.7b | long_500k | — | missing |" in got) == \
        (pod == "pod2")


def test_generator_table_rows_an_error_cell_the_reference_stops_on(
        tmp_path, monkeypatch):
    """The JAX generator reads ``roofline`` of every cell not skipped: an
    error cell stops it.  The port writes the cell's row as ``error`` and
    every other row as the reference does."""
    _write_cells(tmp_path, error=True)
    with pytest.raises(KeyError, match="roofline"):
        _reference_table(tmp_path, "pod1", monkeypatch)
    got = roofline_report.generator_table(tmp_path, "pod1").split("\n")
    error_row = "| qwen1.5-0.5b | train_4k | — | error |  |  |  |  |  |  |"
    assert error_row in got
    clean = tmp_path / "clean"
    _write_cells(clean, error=False)
    want = _reference_table(clean, "pod1", monkeypatch).rstrip("\n")
    assert [r for r in got if r != error_row] == \
        [r for r in want.split("\n") if "| qwen1.5-0.5b | train_4k |" not in r]


def test_compact_table_letters_meshes_and_bold(tmp_path):
    _write_cells(tmp_path, error=True)
    table = roofline_report.compact_table(tmp_path)
    rows = {line.split(" | ")[0].strip("| "): line.split(" | ")[1:]
            for line in table.split("\n")[2:]}
    assert table.split("\n")[0] == \
        "| arch | train_4k | prefill_32k | decode_32k | long_500k |"
    yi = rows["yi-34b"]
    assert yi[0] == "X 382 / 191 s; 46.8 / 37.4 GB"
    assert yi[1] == "X 1,164 / 582 s; 14.7 / 9.5 GB"
    assert yi[3].strip(" |") == "skipped"
    # the peak prints alike at both meshes: one value
    assert rows["mixtral-8x7b"][2] == "M 0.0000770 / 0.0000385 s; 6.1 GB"
    # past the card's 80 GB at pod1 only: bold there
    assert rows["kimi-k2-1t-a32b"][0] == "C 197 / 98.7 s; **158** / 53.1 GB"
    assert rows["qwen1.5-0.5b"][0] == "error"
    assert rows["qwen1.5-0.5b"][1] == "missing"
    assert rows["zamba2-2.7b"][3].strip(" |") == \
        "M 0.000273 s; 0.5 GB / missing"
    one = roofline_report.compact_table(tmp_path, ("pod2",))
    assert "X 191 s; 37.4 GB" in one and "| missing |" in one


def test_summaries_match_the_reference_strings(tmp_path, monkeypatch):
    """``benchmarks/roofline_report.py`` run on the same files, its ``emit``
    captured: the same tag and string for every cell of both meshes."""
    _write_cells(tmp_path, error=True)
    monkeypatch.syspath_prepend(str(ROOT))
    ref = _load(ROOT / "benchmarks" / "roofline_report.py", "roofline_ref")
    seen = []
    monkeypatch.setattr(ref, "ART", tmp_path)
    monkeypatch.setattr(ref, "emit", lambda name, value, note: seen.append(
        (name, note)))
    ref.run()
    got = [(f"roofline_{tag}", text) for pod in ("pod1", "pod2")
           for tag, text in roofline_report.summaries(tmp_path, pod)]
    assert got == seen
    kinds = {text.split("|")[0].split("=")[0] for _, text in got}
    assert kinds == {"dom", "SKIP", "ERROR"}


def test_roofline_report_cli(tmp_path, capsys):
    _write_cells(tmp_path, error=True)
    assert roofline_report.main(["--dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    for pod in ("pod1", "pod2"):
        assert roofline_report.generator_table(tmp_path, pod) in out
        assert f"roofline_yi-34b__train_4k__{pod}: dom=collective" in out
    assert roofline_report.compact_table(tmp_path) in out
    assert roofline_report.main(["--dir", str(tmp_path / "none")]) == 1


# ---------------------------------------------------------------------------
# The quickstart
# ---------------------------------------------------------------------------
def _quickstart_draws():
    """The JAX example's random inputs, as numpy arrays."""
    key = jax.random.PRNGKey(0)
    w = jax.random.uniform(key, (8, 4), minval=-1.0, maxval=1.0)
    xb = jax.random.normal(key, (4, 8))
    w2 = jax.random.uniform(jax.random.PRNGKey(1), (4, 3), minval=-1,
                            maxval=1)
    jlm = _quickstart_jax_config()
    params = jmodel.init_params(jax.random.PRNGKey(2), jlm)
    tokens = jax.random.randint(jax.random.PRNGKey(3), (2, 16), 0,
                                jlm.vocab_size)
    return jlm, {"w": np.asarray(w), "xb": np.asarray(xb),
                 "w2": np.asarray(w2), "tokens": np.asarray(tokens),
                 "params": params}


def test_quickstart_reproduces_the_jax_example(capsys):
    jlm, d = _quickstart_draws()
    spec = JSpec(bits=6)
    tlm = quickstart.lm_config("cpu")
    got = quickstart.run(
        "cpu", w=torch.tensor(d["w"]), xb=torch.tensor(d["xb"]),
        w2=torch.tensor(d["w2"]), tokens=torch.tensor(d["tokens"]),
        params=convert.params_from_numpy(
            jax.tree.map(np.asarray, d["params"]), tlm, "cpu"))
    out = capsys.readouterr().out
    assert "calibrated prefill logits: (2, 1, 256)" in out

    x = jnp.array(quickstart.X)
    w, xb, w2 = (jnp.asarray(d[k]) for k in ("w", "xb", "w2"))
    x_pos, _ = jenc.four_quadrant_split(x)
    prog = jcur.four_quadrant_program(w, spec.i_max, spec.w_max)
    y_sim, (t_plus, t_minus) = jtd.td_vmm_four_quadrant(x, w, spec,
                                                        return_times=True)
    ref = {"t_on": jenc.value_to_onset(x_pos, spec.t_window_s),
           "y_ref": jtd.ideal_four_quadrant(x, w, spec.w_max),
           "exact": xb @ w,
           "ideal_mlp": jtd.ideal_mlp(x, w, w2, spec.w_max)}
    for name, want in ref.items():
        assert _rel(got[name].numpy(), want) <= STEP_RTOL, name
    t = spec.t_window_s
    simulated = {"y_sim": (y_sim, 1.0), "t_plus": (t_plus, t),
                 "t_minus": (t_minus, t),
                 "y_mlp": (jtd.td_mlp_forward(x, w, w2, spec), 1.0)}
    for name, (want, unit) in simulated.items():
        gap = np.abs(got[name].numpy() / unit - np.asarray(want) / unit)
        assert gap.max() <= TD_ATOL, name
    for name in ("pos", "neg", "bias_pos", "bias_neg"):
        assert _rel(got["prog"][name].numpy(), prog[name]) <= STEP_RTOL, name
    # step 5: the codes and the layer's output bitwise
    jcfg = JLayer(enabled=True, bits=6, weight_bits=6, backend="jnp")
    assert np.array_equal(got["y_layer"].numpy(),
                          np.asarray(jtd_matmul(xb, w, jcfg)))
    for tq, jq in ((tquant.encode_input(torch.tensor(d["xb"]), 6),
                    jquant.encode_input(xb, 6)),
                   (tquant.program_weights(torch.tensor(d["w"]), 6),
                    jquant.program_weights(w, 6))):
        assert np.array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    # step 6
    assert got["describe"] == jlm.resolved_tdvmm_plan.describe()
    jbatch = {"inputs": jnp.asarray(d["tokens"])}
    calib = jmodel.calibrate(d["params"], jbatch, jlm)
    assert set(got["windows"]) == set(calib.windows)
    for site, wj in calib.windows.items():
        assert _rel(got["windows"][site].numpy(), wj) <= WINDOW_RTOL, site
    logits, _ = jmodel.prefill_step(d["params"], jbatch,
                                    jmodel.init_caches(jlm, 2, 24), jlm,
                                    calib=calib)
    assert _rel(got["logits"].numpy(), logits) <= LOGIT_RTOL


def test_quickstart_plan_names_the_route_that_runs():
    """The example's ``backend="jnp"`` rule is kept on the CPU (the plain
    path) and becomes ``"auto"`` (the kernels) for the card."""
    assert "jnp" in quickstart.lm_config("cpu").resolved_tdvmm_plan.describe()
    card = quickstart.lm_config("cuda").resolved_tdvmm_plan.describe()
    assert card == _quickstart_jax_config("auto").resolved_tdvmm_plan.describe()


# ---------------------------------------------------------------------------
# serve_lm
# ---------------------------------------------------------------------------
def _summary(out: str) -> list[str]:
    """The printed lines that do not hold a time."""
    lines = [ln for ln in out.splitlines() if ln.startswith("  req ")]
    served = [ln for ln in out.splitlines() if ln.startswith("served ")]
    assert len(lines) == 3 and len(served) == 1
    return lines + [served[0].split(" in ")[0]]


def test_serve_lm_reproduces_the_jax_example(capsys):
    example = _load(ROOT / "examples" / "serve_lm.py", "serve_lm_example")
    example.main()
    ref = capsys.readouterr().out
    jcfg = jsmoke(jget("qwen1.5-0.5b")).replace(tdvmm_plan=JPlan(rules=(
        jrule("ffn.*", enabled=True, backend="auto"),
        jrule("ffn.in", chain=True))))
    tcfg = serve_lm.config()
    params = convert.params_from_numpy(jax.tree.map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(0), jcfg)), tcfg,
        "cpu")
    calib_tokens = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (serve_lm.BATCH_SLOTS, 16), 0,
        jcfg.vocab_size))
    got = serve_lm.run("cpu", params=params,
                       calib_tokens=torch.tensor(calib_tokens))
    out = capsys.readouterr().out
    assert _summary(out) == _summary(ref)
    assert out.split("calibrated sites:")[0] == ref.split(
        "calibrated sites:")[0]
    assert got["total_tokens"] == sum(
        1 + gen for _, gen in serve_lm.make_requests(tcfg.vocab_size))
