#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root

Phases, each of which stops the script with a non-zero exit on failure:

1. environment: the card's name and power limit; TF32 off, deterministic
   algorithms on;
2. build: kernels B1 (``csrc/tdvmm.cu``) and B2 (``csrc/tdvmm_calib.cu``)
   with ``nvcc`` from the checkout's sources;
3. kernels: every mode of B1 (raw, fused without readout, scalar window,
   (E,) window, shared-x) and B2 (one slot, E slots) against its plain torch
   version on the card at the serving path's shapes, bitwise
   (``max_abs_err == 0``), with kernel / plain / bound / library times;
4. serving: qwen1.5-0.5b at full width (24 layers, d_model 1024, bf16,
   random weights from seed 0) under the ``ffn_unchained`` and
   ``ffn_chained`` plans: one calibration pass, then the paged engine
   serves 8 ragged requests; every request must finish with its full token
   budget, no NaN logits, its stream equal to the same request served alone,
   and the kernel launch counts must match the plan's sites exactly;
5. small input: the card's kernel path against the CPU plain path at smoke
   width, same weights.

It then prints one ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line.  Without a CUDA device, or run from a
directory that does not hold the repository, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
# cuBLAS reads this once, at its first handle: set before torch starts it.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

H100_HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
H100_INT8_OPS_PER_S = 1979e12       # dense int8 tensor-core rate

ARCH = "qwen1.5-0.5b"
CHUNK, SLOTS, PAGE, NUM_PAGES = 64, 4, 16, 64
CALIB_BATCH = (2, 64)
CALIB_ROWS = CALIB_BATCH[0] * CALIB_BATCH[1]
FFN_SHAPES = ((1024, 2816), (2816, 1024))       # ffn.in (K, N), ffn.out
PROFILE_SKIP, PROFILE_STEPS = 16, 12             # engine ticks
# Phase 5, card against CPU logits relative to max|logit|: the TD-VMM codes
# are bitwise on both, so only float32 reductions outside the kernels
# (attention, norms, the head) differ; measured 6e-7 on an H100.
SMALL_LOGIT_RTOL = 1e-5

SOURCES = {"tdvmm_fused": "src/repro_torch/kernels/tdvmm/csrc/tdvmm.cu",
           "tdvmm_matmul_raw": "src/repro_torch/kernels/tdvmm/csrc/tdvmm.cu",
           "tdvmm_calibrated": "src/repro_torch/kernels/tdvmm/csrc/tdvmm_calib.cu"}
REPLACES = {"tdvmm_fused": "src/repro/kernels/tdvmm/tdvmm.py:233",
            "tdvmm_matmul_raw": "src/repro/kernels/tdvmm/tdvmm.py:233",
            "tdvmm_calibrated": "src/repro/kernels/tdvmm/tdvmm.py:440"}
COUNTER = {"tdvmm_fused": "fused", "tdvmm_matmul_raw": "raw",
           "tdvmm_calibrated": "calibrated"}


def say(tag: str, msg: str) -> None:
    print(f"[{tag}] t={time.perf_counter() - T_START:.0f}s {msg}", flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# Phase 1: environment
# ---------------------------------------------------------------------------
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def device_profile(fn) -> tuple[float, dict[str, float], int]:
    """(host wall seconds, device microseconds by kernel name, kernels run)
    of one call of ``fn``, from ``torch.profiler``'s CUDA activity; copies
    and fills are in the times but not in the kernel count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # device activity only: host-side op events would cost minutes to parse
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict[str, float] = {}
    kernels = 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) \
                + ev.time_range.elapsed_us()
            kernels += not ev.name.startswith(("Memcpy", "Memset"))
    return wall, by_name, kernels


def time_ms(fn, iters: int) -> float:
    """Device milliseconds of one call of ``fn``: CUDA events around
    ``iters`` calls that were all queued while the card slept, so the
    elapsed time is the card's alone, with no host launch gaps in it."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    cycles = 50_000_000
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_ahead = not start.query()
        end.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise SmokeFailure("the timed calls could not be queued ahead of the card")


def kernel_cases() -> list[dict]:
    """Every kernel mode at the serving path's shapes: M = prefill chunk C,
    decode batch B, calibration rows; (K, N) of ffn.in and ffn.out; one
    ragged shape.  ``rep`` marks the row a kernel's JSON entry reports."""
    cases = []
    for k, n in FFN_SHAPES:
        cases.append(dict(kernel="tdvmm_matmul_raw", mode="raw", e=1, ex=1,
                          m=CALIB_ROWS, k=k, n=n, rep=(k, n) == FFN_SHAPES[0]))
        for m in (CHUNK, SLOTS):
            cases.append(dict(kernel="tdvmm_fused", mode="no_readout", e=1,
                              ex=1, m=m, k=k, n=n))
            cases.append(dict(kernel="tdvmm_fused", mode="scalar_window",
                              e=1, ex=1, m=m, k=k, n=n,
                              rep=(m, k, n) == (CHUNK,) + FFN_SHAPES[0]))
        cases.append(dict(kernel="tdvmm_calibrated", mode="one_slot", e=1,
                          ex=1, m=CALIB_ROWS, k=k, n=n,
                          rep=(k, n) == FFN_SHAPES[0]))
    k, n = FFN_SHAPES[0]
    cases += [
        dict(kernel="tdvmm_fused", mode="expert_windows", e=3, ex=3,
             m=CHUNK, k=k, n=n),
        dict(kernel="tdvmm_fused", mode="shared_x_window", e=3, ex=1, m=CHUNK,
             k=k, n=n),
        dict(kernel="tdvmm_calibrated", mode="expert_slots", e=3, ex=3,
             m=CHUNK, k=k, n=n),
        dict(kernel="tdvmm_matmul_raw", mode="raw", e=1, ex=1, m=3, k=130,
             n=200),
        dict(kernel="tdvmm_fused", mode="scalar_window", e=1, ex=1, m=3,
             k=130, n=200),
        dict(kernel="tdvmm_calibrated", mode="one_slot", e=1, ex=1, m=3,
             k=130, n=200),
    ]
    return cases


def bound(case: dict) -> tuple[float, str]:
    """Least time for the work: each input read once, each output written
    once, against the operations at the int8 tensor-core rate."""
    e, ex, m, k, n = (case[f] for f in ("e", "ex", "m", "k", "n"))
    nbytes = ex * m * k + e * k * n + 4 * e * m * n       # codes in, out
    if case["mode"] != "raw":
        nbytes += 4 * (ex * m + e * n)                     # scales
    if "window" in case["mode"]:
        nbytes += 4 * e
    t_bytes = nbytes / H100_HBM_BYTES_PER_S
    t_ops = 2.0 * e * m * k * n / H100_INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def run_case(case: dict, dev, seed: int) -> dict:
    import torch
    from repro_torch.kernels.tdvmm import ops, tdvmm as tk

    e, ex, m, k, n = (case[f] for f in ("e", "ex", "m", "k", "n"))
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randint(-63, 64, (ex, m, k), generator=g, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-63, 64, (e, k, n), generator=g, device=dev,
                      dtype=torch.int8)
    xs = torch.rand((ex, m), generator=g, device=dev) + 0.5
    ws = torch.rand((e, n), generator=g, device=dev) + 0.5
    gain = 1.0 / (63.0 * 63.0 * 2.0 * k)
    mode = case["mode"]
    window = None
    if "window" in mode:
        z = tk.acc_plain(x, w).to(torch.float32) * float(gain)
        zmax = torch.amax(torch.abs(z), dim=(1, 2)) * 0.7
        window = zmax if mode == "expert_windows" else zmax[0].reshape(())
    bits = None if mode in ("raw", "no_readout") else 6
    if case["kernel"] == "tdvmm_matmul_raw":
        kern = lambda: tk.tdvmm_matmul_raw(x, w)                  # noqa: E731
        plain = lambda: tk.tdvmm_raw_plain(x, w)                  # noqa: E731
    elif case["kernel"] == "tdvmm_fused":
        kern = lambda: tk.tdvmm_fused(x, w, xs, ws, gain, bits, window)  # noqa: E731
        plain = lambda: tk.tdvmm_fused_plain(x, w, xs, ws, gain, bits,   # noqa: E731
                                             window)
    else:
        slots, nslots = ops._calib_slots(e, n, tk.TILE_N, None)
        slots = slots.to(dev)
        bw = min(tk.TILE_N, n)
        kern = lambda: tk.tdvmm_calibrated(x, w, xs, ws, slots, nslots,  # noqa: E731
                                           bw, gain, 6)
        plain = lambda: tk.tdvmm_calibrated_plain(x, w, xs, ws, slots,   # noqa: E731
                                                  nslots, bw, gain, 6)
    yk, yp = kern(), plain()
    torch.cuda.synchronize()
    require(yk.dtype == yp.dtype and yk.shape == yp.shape,
            f"{case}: kernel {yk.dtype}{tuple(yk.shape)} vs plain "
            f"{yp.dtype}{tuple(yp.shape)}")
    require(bool(torch.isfinite(yp.to(torch.float32)).all()),
            f"{case}: non-finite plain output")
    err = float((yk.to(torch.float64) - yp.to(torch.float64)).abs().max())
    require(err == 0.0, f"{case}: kernel differs from plain by {err}")

    library = None
    if e == 1 and ex == 1 and m > 16 and k % 8 == 0 and n % 8 == 0:
        x2, w2 = x[0], w[0]
        if case["kernel"] == "tdvmm_matmul_raw":
            library = lambda: torch._int_mm(x2, w2)[None]         # noqa: E731
        else:
            library = lambda: ops._epilogue(                      # noqa: E731
                torch._int_mm(x2, w2)[None], xs, ws, gain, bits, None,
                out_window=window)
        ylib = library()
        torch.cuda.synchronize()
        require(bool(torch.equal(ylib, yp)),
                f"{case}: the library yardstick computes another function")
    bound_ms, bound_by = bound(case)
    row = dict(case, max_abs_err=err, ms=time_ms(kern, 20),
               plain_ms=time_ms(plain, 5), bound_ms=bound_ms,
               bound_by=bound_by,
               library_ms=None if library is None else time_ms(library, 10))
    row.pop("rep", None)
    return row


# ---------------------------------------------------------------------------
# Phase 4: serving at full width
# ---------------------------------------------------------------------------
def plans():
    from repro_torch.configs import TDVMMPlan, tdvmm_rule
    return {
        "ffn_unchained": TDVMMPlan(rules=(
            tdvmm_rule("ffn.*", enabled=True, backend="auto"),)),
        "ffn_chained": TDVMMPlan(rules=(
            tdvmm_rule("ffn.*", enabled=True, backend="auto"),
            tdvmm_rule("ffn.in", chain=True))),
    }


def make_trace(vocab: int, seed: int = 0):
    """8 ragged requests: prompts of 16-128 tokens, 8-32 new tokens,
    arrival gaps of 0-2 engine steps."""
    import numpy as np
    from repro_torch.runtime.engine import Request
    rng = np.random.default_rng(seed)
    reqs, arrival = [], 0
    for rid in range(8):
        reqs.append(Request(
            rid=rid,
            prompt=tuple(int(t) for t in rng.integers(
                0, vocab, int(rng.integers(16, 129)))),
            max_new_tokens=int(rng.integers(8, 33)),
            arrival_step=arrival))
        arrival += int(rng.integers(0, 3))
    return reqs


def expected_launches(cfg, plan: str, steps: int) -> dict:
    """Exact kernel launches of the main path: every ffn matmul of every
    layer is one TD-VMM launch; the calibration pass captures each
    digital-boundary matmul once (B1 raw) and reads it out data-calibrated
    (B2), and a chained ffn.in has no readout (B1 fused)."""
    n_in = 2 if cfg.act == "silu_glu" else 1
    per_layer = n_in + 1
    readouts = 1 if plan == "ffn_chained" else per_layer
    L = cfg.n_layers
    return {"calibrate": {"raw": L * readouts, "calibrated": L * readouts,
                          "fused": L * (per_layer - readouts)},
            "serve": {"raw": 0, "calibrated": 0,
                      "fused": L * per_layer * steps}}


def serve_plan(name: str, plan, dev, params_cache: dict) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.tdvmm import tdvmm as tk
    from repro_torch.models import model
    from repro_torch.runtime.engine import Engine, EngineConfig, Request
    from repro_torch.runtime.paged_cache import pages_for

    cfg = get_config(ARCH).replace(tdvmm_plan=plan)
    if "params" not in params_cache:
        params_cache["params"] = model.init_params(0, cfg, device=dev)
    params = params_cache["params"]
    trace = make_trace(cfg.vocab_size)
    max_len = max(len(r.prompt) + r.max_new_tokens for r in trace)
    ecfg = EngineConfig(slots=SLOTS, page_size=PAGE, num_pages=NUM_PAGES,
                        chunk=CHUNK, max_pages_per_slot=pages_for(max_len, PAGE))
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    calib_tokens = torch.randint(0, cfg.vocab_size, CALIB_BATCH, generator=g,
                                 device=dev)

    # ---- the main path: counts at 0, calibrate, serve, read ---------------
    tk.reset_launches()
    t0 = time.perf_counter()
    calib = model.calibrate(params, {"inputs": calib_tokens}, cfg)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    at_calib = dict(tk.LAUNCHES)
    engine = Engine(cfg, params, ecfg, calib=calib)
    rep = engine.run(trace)
    torch.cuda.synchronize()
    launches = dict(tk.LAUNCHES)
    serve_launches = {k: launches[k] - at_calib[k] for k in launches}

    steps = rep.prefill_steps + rep.decode_steps
    want = expected_launches(cfg, name, steps)
    require(at_calib == want["calibrate"],
            f"{name}: calibration launches {at_calib} != {want['calibrate']}")
    require(serve_launches == want["serve"],
            f"{name}: serving launches {serve_launches} != {want['serve']}")
    require(set(calib.sites()) == ({"ffn.out"} if name == "ffn_chained"
                                   else {"ffn.in", "ffn.out"}),
            f"{name}: calibrated sites {calib.sites()}")
    require(rep.nan_logit_steps == 0, f"{name}: {rep.nan_logit_steps} NaN steps")
    require(rep.step_shapes == 2, f"{name}: {rep.step_shapes} step shapes")
    for req, rec in zip(trace, rep.requests):
        require(rec["finish_reason"] == "max_tokens"
                and len(rec["tokens"]) == req.max_new_tokens,
                f"{name}: request {req.rid} finished {rec['finish_reason']} "
                f"with {len(rec['tokens'])} of {req.max_new_tokens} tokens")
    # each stream equals its request served alone (same engine config)
    for req, rec in zip(trace, rep.requests):
        solo = Engine(cfg, params, ecfg, calib=calib).run(
            [Request(req.rid, req.prompt, req.max_new_tokens, 0)])
        require(solo.requests[0]["tokens"] == rec["tokens"],
                f"{name}: request {req.rid} batched stream differs from solo")
    return dict(plan=name, requests=len(trace), steps=rep.steps,
                prefill_steps=rep.prefill_steps, decode_steps=rep.decode_steps,
                generated_tokens=rep.generated_tokens,
                serve_s=rep.wall_s, calibrate_s=t_cal,
                tokens_per_s=rep.generated_tokens / rep.wall_s,
                fj_per_op=rep.fj_per_op, utilization=rep.utilization,
                launches=launches, launches_calibrate=at_calib,
                engine_args=(cfg, params, ecfg, calib), trace=trace)


def profile_plan(out: dict) -> dict:
    """Where the device time goes: a window of engine steps of the plan's
    trace, profiled after the first prefills (it mixes prefill and
    decode).  Device-busy share = summed kernel time over the window's
    wall time; kernels per step = device kernels run in the window over its
    engine steps."""
    from repro_torch.runtime.engine import Engine

    cfg, params, ecfg, calib = out["engine_args"]
    eng = Engine(cfg, params, ecfg, calib=calib)
    eng.start(out["trace"])
    for _ in range(PROFILE_SKIP):
        eng.tick()
    before = (eng._st.prefill_steps, eng._st.decode_steps)

    def window():
        for _ in range(PROFILE_STEPS):
            eng.tick()
    wall, by_name, kernels = device_profile(window)
    dev_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(
        steps=(eng._st.prefill_steps - before[0],
               eng._st.decode_steps - before[1]),
        kernels_per_step=kernels / PROFILE_STEPS,
        wall_s=wall, device_busy_share=dev_us / 1e6 / wall,
        tdvmm_device_share=sum(v for k, v in by_name.items()
                               if "tdvmm::" in k) / max(dev_us, 1e-9),
        top_kernels=[(k[:70], v / max(dev_us, 1e-9)) for k, v in top])


# ---------------------------------------------------------------------------
# Phase 5: the card's kernel path against the CPU plain path, small input
# ---------------------------------------------------------------------------
def small_input_agreement(dev) -> float:
    """Smoke-width qwen (2 layers, float32), the same weights on the card
    (kernels) and on the CPU (plain versions): equal greedy tokens, logits
    within SMALL_LOGIT_RTOL of max|logit|."""
    import torch
    from repro_torch.configs import get_config, smoke
    from repro_torch.models import model

    cfg = smoke(get_config(ARCH)).replace(tdvmm_plan=plans()["ffn_unchained"])
    p_cpu = model.init_params(0, cfg, device="cpu")
    p_dev = {"embed": {"table": p_cpu["embed"]["table"].to(dev)},
             "ln_f": {"scale": p_cpu["ln_f"]["scale"].to(dev)},
             "blocks": {"seg0": [_to(layer, dev)
                                 for layer in p_cpu["blocks"]["seg0"]]}}
    prompt = torch.arange(3, 19).reshape(1, 16)
    calib = model.calibrate(p_cpu, {"inputs": prompt.repeat(2, 1)}, cfg,
                            device="cpu")
    worst = 0.0
    for p, d in ((p_cpu, "cpu"), (p_dev, dev)):
        caches = model.init_caches(cfg, 1, 24, d)
        logits, caches = model.prefill_step(p, {"inputs": prompt.to(d)},
                                            caches, cfg, calib=calib)
        rows, toks = [logits[0, -1].float().cpu()], []
        for _ in range(7):
            toks.append(int(torch.argmax(rows[-1])))
            logits, caches = model.decode_step(
                p, {"inputs": torch.tensor([[toks[-1]]], device=d)}, caches,
                cfg, calib=calib)
            rows.append(logits[0, -1].float().cpu())
        if d == "cpu":
            ref_rows, ref_toks = torch.stack(rows), toks
        else:
            got = torch.stack(rows)
            worst = float((got - ref_rows).abs().max()
                          / ref_rows.abs().max())
            require(toks == ref_toks, f"card tokens {toks} != cpu {ref_toks}")
    require(worst <= SMALL_LOGIT_RTOL,
            f"card logits differ from cpu by {worst:.3g}")
    return worst


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------------------
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} does not hold the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.tdvmm import tdvmm as tk

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    say("env", f"{kind} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # deterministic kernels for the batched == solo check, without the
    # NaN fill of every fresh allocation that the mode adds by default
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False

    build_s = tk.build(verbose=True)
    say("build", f"B1 + B2 built in {build_s:.1f} s")

    rows = []
    for i, case in enumerate(kernel_cases()):
        row = run_case(case, dev, seed=i)
        rows.append((case, row))
        lib = row["library_ms"]
        say("kernel", f"{row['kernel']:<17} {row['mode']:<15} E={row['e']} "
            f"x{row['ex']} M={row['m']:<4} K={row['k']:<5} N={row['n']:<5} "
            f"max_abs_err={row['max_abs_err']} kernel_ms={row['ms']:.5f} "
            f"plain_ms={row['plain_ms']:.5f} bound_ms={row['bound_ms']:.5f} "
            f"({row['bound_by']}) library_ms="
            f"{'n/a' if lib is None else format(lib, '.5f')}")

    served, cache = [], {}
    for name, plan in plans().items():
        out = serve_plan(name, plan, dev, cache)
        served.append(out)
        say("serve", f"{name}: {out['generated_tokens']} tokens for "
            f"{out['requests']} requests in {out['steps']} steps "
            f"({out['prefill_steps']} prefill + {out['decode_steps']} "
            f"decode), {out['tokens_per_s']:.2f} tokens/s "
            f"({out['serve_s']:.2f} s), calibrate {out['calibrate_s']:.2f} s, "
            f"{out['fj_per_op']:.3f} fJ/Op, utilization "
            f"{out['utilization']:.3f}, launches calibrate "
            f"{out['launches_calibrate']} total {out['launches']}, "
            "batched == solo")
    for out in served:
        prof = profile_plan(out)
        say("profile", f"{out['plan']}: {prof['steps'][0]} prefill + "
            f"{prof['steps'][1]} decode steps in {prof['wall_s']:.3f} s, "
            f"{prof['kernels_per_step']:.1f} device kernels per step, "
            f"device busy {prof['device_busy_share']:.3f}, TD-VMM kernels "
            f"{prof['tdvmm_device_share']:.3f} of device time; top "
            + "; ".join(f"{k} {v:.3f}" for k, v in prof["top_kernels"]))
        del out["engine_args"]
    del cache
    torch.cuda.empty_cache()

    worst = small_input_agreement(dev)
    say("small", "card vs cpu plain path: equal greedy tokens, logits "
        f"within {worst:.3g} of max|logit|")

    kernels = []
    for name in SOURCES:
        mine = [r for c, r in rows if r["kernel"] == name]
        rep = next(r for c, r in rows if c["kernel"] == name and c.get("rep"))
        launches = sum(s["launches"][COUNTER[name]] for s in served)
        require(launches > 0, f"{name} was not launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"],
            "shape": {k: rep[k] for k in ("mode", "e", "m", "k", "n")}})
    say("done", "all phases passed")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
