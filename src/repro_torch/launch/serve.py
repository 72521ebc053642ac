"""Serving CLI over the port's continuous-batching engine:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --tdvmm 'ffn.*' --chain --calibrate --requests 8

runs a seeded ragged trace through ``runtime.engine.Engine`` on the card.
The engine serves the dense and the MoE families (kimi-k2-1t-a32b: 384
experts, top-8, a shared expert; ``chip_smoke.py`` serves one full-width
layer of it):

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch kimi-k2-1t-a32b --smoke --tdvmm 'moe.*' --calibrate \
        --device cpu

``--static`` serves one uniform batch instead — one prefill, then greedy
decode steps — the only path for SSM models and for sliding-window models
such as mixtral-8x7b, and for the hybrid zamba2-2.7b, as in the JAX
package:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \\
        --static --tdvmm 'ssm.*' --calibrate --batch 4 --prompt-len 512 \\
        --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \\
        --static --tdvmm 'moe.*' --calibrate --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-large \\
        --static --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
        --static --kv-int8 --smoke --device cpu

(the embedding-input archs, llava-next-mistral-7b and musicgen-large, take
a random normal (batch, prompt_len, d_model) prompt and one (batch, 1,
d_model) decode input, as the JAX package's ``serve()`` does)

(mixtral-8x7b's published 32 layers, ~93 GB in bf16, exceed one 80 GB card;
``chip_smoke.py`` serves it at full width with 8.)

zamba2-2.7b (the hybrid family: Mamba-2 groups with a shared attention
block) is served by the static path only, as in the JAX package; prompts
past 2048 tokens run its shared block through flash attention.
``--kv-int8`` stores every KV cache, the dense one and the engine's page
pools, as int8 codes with per-(token, head) scales.

``--device cpu`` runs the plain torch path on the CPU; add ``--smoke`` for
the reduced same-family model.  Weights are random, drawn from ``--seed``.
``--plan-report`` prints the resolved TD-VMM site table on either path:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --smoke --device cpu --tdvmm 'ffn.*' --plan-report [--static]

The engine path is fault tolerant.  ``--snapshot-dir`` installs SIGTERM and
SIGINT handlers: a preempted run saves its whole in-flight state there and
exits; ``--resume`` restores the latest snapshot and serves the rest of the
trace, with the same streams as an unbroken run.  Faults can be injected at
an engine step (``--preempt-at``, ``--fail-at``, ``--drift-at``,
``--slow-at``), and ``--drift-check-every`` probes the pinned windows and
recalibrates in place when they have drifted:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --smoke --tdvmm 'ffn.*' --calibrate --device cpu \\
        --snapshot-dir /tmp/snap --preempt-at 10
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --smoke --tdvmm 'ffn.*' --calibrate --device cpu \\
        --snapshot-dir /tmp/snap --resume

SLA, telemetry and tracing (engine path): ``--sla`` schedules by priority
with aging (the trace's priorities cycle ``rid % 3``) and rejects
deadline- or joule-infeasible requests at admission (``--deadline-steps``,
``--joule-budget`` stamp every request); ``--metrics-jsonl`` and
``--alert-on`` stream per-tick metrics and alerts through a metrics sink
(``--clip-observe-every`` adds the per-site ``clip_rate.<site>`` series);
``--trace-out`` writes the request lifecycle as a Chrome trace, which
``python -m repro_torch.launch.trace_report`` renders as markdown;
``--report-json`` writes the whole report:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --smoke --tdvmm 'ffn.*' --calibrate --device cpu --sla \\
        --metrics-jsonl /tmp/m.jsonl --clip-observe-every 2 \\
        --alert-on 'clip_rate.ffn.out:threshold:limit=0.01' \\
        --trace-out /tmp/trace.json --report-json /tmp/report.json

``--mesh DxT`` serves on a (data, model) mesh, one process per device
(``launch.mesh``; NCCL on the card, gloo with ``--device cpu``); every rank
runs the same command:

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.serve --arch qwen1.5-0.5b --smoke \
        --tdvmm 'ffn.*' --calibrate --device cpu --mesh 2x2
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint
from repro_torch.configs import TDVMMPlan, get_config, smoke as smoke_cfg, tdvmm_rule
from repro_torch.core.calibration import CalibrationState
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import meshctx, sharding, steps
from repro_torch.launch.mesh import axis_info
from repro_torch.models import attention, common, model
from repro_torch.runtime import fault
from repro_torch.runtime import faultinject as fi
from repro_torch.runtime import telemetry as tele
from repro_torch.runtime.engine import (DriftConfig, Engine, EngineConfig,
                                        FaultConfig, Request)
from repro_torch.runtime.paged_cache import pages_for
from repro_torch.runtime.sla import SlaConfig
from repro_torch.runtime.trace import Tracer
from repro_torch.tree import leaves_with_paths


def make_trace(vocab: int, n: int, prompt_len: int, gen: int, seed: int,
               sla: bool = False, deadline_steps=None,
               joule_budget=None) -> list[Request]:
    """Seeded ragged trace: prompts in [prompt_len/4, prompt_len], budgets in
    [gen/4, gen], arrival gaps in [0, 2] steps.  With ``sla`` the
    priorities cycle ``rid % 3``; ``deadline_steps`` and ``joule_budget``
    are stamped on every request (inert without an SLA policy)."""
    rng = np.random.default_rng(seed)
    lo, hi = max(1, prompt_len // 4), prompt_len + 1
    reqs, arrival = [], 0
    for rid in range(n):
        reqs.append(Request(
            rid=rid,
            prompt=tuple(int(t) for t in
                         rng.integers(0, vocab, rng.integers(lo, hi))),
            max_new_tokens=int(rng.integers(max(1, gen // 4), gen + 1)),
            arrival_step=arrival,
            priority=(rid % 3) if sla else 0,
            deadline_steps=deadline_steps, joule_budget=joule_budget))
        arrival += int(rng.integers(0, 3))
    return reqs


def parse_alert_spec(spec: str) -> tele.AlertRule:
    """One ``--alert-on`` value -> AlertRule.

    Format: ``metric:kind[:key=val[,key=val...]]``, e.g.
    ``step_latency_s:spike:k=6,abs_floor=0.05`` or
    ``fj_per_op:regression:baseline=57.1,tol=0.1``."""
    parts = spec.split(":", 2)
    if len(parts) < 2:
        raise SystemExit(f"--alert-on {spec!r}: want metric:kind[:k=v,...]")
    metric, kind = parts[0], parts[1]
    kwargs = {}
    if len(parts) == 3 and parts[2]:
        for kv in parts[2].split(","):
            k, sep, v = kv.partition("=")
            if not sep:
                raise SystemExit(f"--alert-on {spec!r}: bad param {kv!r}")
            kwargs[k] = int(v) if k == "min_samples" else float(v)
    try:
        return tele.AlertRule(metric=metric, kind=kind, **kwargs)
    except (TypeError, ValueError) as e:
        raise SystemExit(f"--alert-on {spec!r}: {e}")


def make_sink(args) -> tele.MetricsSink | None:
    """The run's MetricsSink (None: telemetry off), enabled by
    ``--metrics-jsonl`` and/or ``--alert-on``.  With no rule given, a
    step-latency spike rule (median + 6 MAD, 50 ms absolute deadband) is
    installed: a cold engine's first steps may alert, warm traffic not."""
    if not (args.metrics_jsonl or args.alert_on):
        return None
    rules = [parse_alert_spec(s) for s in (args.alert_on or [])]
    if not rules:
        rules = [tele.AlertRule("step_latency_s", kind="spike", k=6.0,
                                abs_floor=0.05)]
    emitters = [tele.StdoutEmitter()]
    if args.metrics_jsonl:
        emitters.append(tele.JsonlEmitter(args.metrics_jsonl))
    return tele.MetricsSink(rules=rules, emitters=emitters)


def fault_config(args, probe_batch=None, sink=None) -> FaultConfig | None:
    """The engine's FaultConfig from the CLI flags (None: no wiring).

    A snapshot directory installs a real ``PreemptionGuard`` (SIGTERM and
    SIGINT handlers), so an eviction saves the in-flight state there; the
    ``--*-at`` flags inject the same faults at a chosen engine step.  A
    metrics ``sink`` also takes the straggler monitor's and the
    heartbeat's samples."""
    events = []
    if args.preempt_at is not None:
        events.append(fi.PreemptAt(args.preempt_at))
    if args.fail_at is not None:
        events.append(fi.FailStep(step=args.fail_at, kind=args.fail_kind,
                                  times=args.fail_times))
    if args.drift_at is not None:
        events.append(fi.DriftAt(args.drift_at, sigma=args.drift_sigma))
    if args.slow_at is not None:
        events.append(fi.SlowStep(args.slow_at, sleep_s=args.slow_sleep))
    drift = None
    if args.drift_check_every > 0 or args.clip_observe_every > 0:
        if probe_batch is None:
            raise SystemExit("a drift probe (--drift-check-every, "
                             "--clip-observe-every) requires --calibrate "
                             "(it compares against the pinned windows)")
        drift = DriftConfig(probe_batch=probe_batch,
                            # observe-only wiring leaves the full check
                            # off in effect (the clip series still stream)
                            check_every=args.drift_check_every or 10**9,
                            clip_threshold=args.drift_clip,
                            window_tol=args.drift_tol,
                            observe_every=args.clip_observe_every)
    hb = (fault.Heartbeat(args.heartbeat, args.heartbeat_every, sink=sink)
          if args.heartbeat else None)
    if not (events or drift or hb or args.snapshot_dir):
        return None
    return FaultConfig(
        guard=fault.PreemptionGuard().install() if args.snapshot_dir
        else None,
        snapshot_dir=args.snapshot_dir, retries=args.retries,
        injector=fi.FaultInjector(events) if events else None,
        drift=drift, heartbeat=hb, monitor=fault.StragglerMonitor(sink=sink))


def print_plan(cfg) -> None:
    """The resolved TD-VMM site table (``--plan-report``)."""
    print("[serve] TD-VMM plan:")
    print(cfg.resolved_tdvmm_plan.describe())


def serve_engine(cfg, args, mesh=None):
    """The engine path; with ``mesh`` one rank of a mesh-sharded engine
    (every rank runs this with the same arguments)."""
    device = common.resolve_device(args.device)
    params = model.init_params(args.seed, cfg, device=device)
    calib = batch = None
    if args.calibrate:
        gen = torch.Generator().manual_seed(args.seed + 1)
        batch = {"inputs": torch.randint(
            0, cfg.vocab_size, (min(args.slots, 4), args.prompt_len),
            generator=gen)}
        calib = model.calibrate(params, batch, cfg, device=device)
        print(f"[serve] calibrated sites: {calib.sites()}")
    if args.plan_report:
        print_plan(cfg)
    reqs = make_trace(cfg.vocab_size, args.requests, args.prompt_len,
                      args.gen, args.seed, sla=args.sla,
                      deadline_steps=args.deadline_steps,
                      joule_budget=args.joule_budget)
    ecfg = EngineConfig(
        slots=args.slots, page_size=args.page_size, num_pages=args.num_pages,
        chunk=args.chunk,
        max_pages_per_slot=min(args.num_pages, pages_for(
            args.prompt_len + args.gen, args.page_size)))
    sla = SlaConfig(aging_steps=args.aging_steps) if args.sla else None
    sink = make_sink(args)
    tracer = Tracer() if args.trace_out else None
    fc = fault_config(args, probe_batch=batch, sink=sink)
    kw = dict(calib=calib, sla=sla, sink=sink, tracer=tracer, device=device,
              mesh=mesh)
    try:
        if args.resume:
            if not args.snapshot_dir:
                raise SystemExit("--resume requires --snapshot-dir")
            # the snapshot carries the pinned (possibly recalibrated)
            # windows: the engine is built on them, then restored
            flat, step = checkpoint.load_engine_snapshot(args.snapshot_dir)
            calib = CalibrationState(windows={
                k.split("/", 1)[1]: v for k, v in flat.items()
                if k.startswith("windows/")})
            kw["calib"] = calib
            engine = Engine(cfg, params, ecfg, **kw)
            engine.restore(flat)
            print(f"[serve] resumed from snapshot step {step} "
                  f"({args.snapshot_dir})")
            rep = engine.resume(fc)
        else:
            rep = Engine(cfg, params, ecfg, **kw).run(reqs, fc)
    finally:
        if fc is not None and fc.guard is not None:
            fc.guard.uninstall()
        if sink is not None:
            for em in sink.emitters:
                em.close()
    if rep.preempted:
        print(f"[serve] PREEMPTED at step {rep.steps}; snapshot: "
              f"{rep.snapshot_path} (resume with --resume)")
    if rep.step_retries or rep.failed:
        print(f"[serve] faults: {rep.step_retries} step retries, "
              f"{rep.failed} requests failed")
    if rep.recalibrations or rep.drift_events:
        print(f"[serve] drift: {len(rep.drift_events)} events, "
              f"{rep.recalibrations} online recalibrations (step shapes "
              f"still {rep.step_shapes})")
    if mesh is not None:
        print(f"[serve] mesh: {rep.devices} devices, {rep.total_slots} "
              f"slots")
    print(f"[serve] {device}: {len(reqs)} requests, {rep.generated_tokens} "
          f"tokens in {rep.steps} steps ({rep.prefill_steps} chunk + "
          f"{rep.decode_steps} decode, "
          f"{rep.generated_tokens / max(rep.wall_s, 1e-9):.1f} tok/s), "
          f"utilization {rep.utilization:.2f}, step shapes {rep.step_shapes}")
    if rep.analog_ops:
        print(f"[serve] analog: {rep.analog_ops:.3g} Ops, "
              f"{rep.fj_per_op:.2f} fJ/Op, {rep.tokens_per_joule:.3g} tok/J")
    if sla is not None:
        print(f"[serve] sla: {rep.rejected} rejected at admission, "
              f"{rep.over_budget} over budget, deadlines "
              f"{rep.deadline_hits} hit / {rep.deadline_misses} missed")
    if sink is not None:
        tel = rep.telemetry
        by_rule = ", ".join(f"{k}={v}" for k, v in
                            sorted(tel["alerts_by_rule"].items()))
        print(f"[serve] telemetry: {tel['observations']} samples, "
              f"{rep.alerts} alerts ({by_rule or 'none'})"
              + (f"; streamed to {args.metrics_jsonl}"
                 if args.metrics_jsonl else ""))
    if tracer is not None:
        doc = tracer.chrome_trace()
        Path(args.trace_out).write_text(json.dumps(doc))
        pct = rep.trace_summary["percentiles"]["total_us"]
        print(f"[serve] trace: {len(doc['traceEvents'])} events over "
              f"{rep.trace_summary['ticks']} ticks -> {args.trace_out} "
              f"(request total p50 {pct['p50']:.0f} us / p95 "
              f"{pct['p95']:.0f} us of host wall time; open in Perfetto)")
    for r in rep.requests[:4]:
        print(f"[serve]   req {r['rid']}: {r['finish_reason']} "
              f"tokens={r['tokens'][:8]}")
    if args.report_json:
        Path(args.report_json).write_text(json.dumps(rep.to_json(), indent=1))
        print(f"[serve] report written to {args.report_json}")
    return rep


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_static(cfg, batch: int, prompt_len: int, gen: int, seed: int = 0,
                 calibrate: bool = False, calib=None, device=None,
                 params=None, prompts=None, decode_inputs=None,
                 mesh=None, plan_report: bool = False) -> dict:
    """Uniform-batch prefill + greedy decode (the JAX package's ``serve()``
    without a mesh).  ``calibrate=True`` runs the model-wide readout-window
    pass on the prompt batch first and serves with every TD-VMM site's
    window pinned; ``calib`` passes a captured state instead.  ``params``
    and ``prompts`` default to random ones from ``seed``: (batch,
    prompt_len) token ids, or for ``input_mode == "embeddings"`` archs a
    (batch, prompt_len, d_model) float32 normal draw.  Those archs feed one
    (batch, 1, d_model) input, ``decode_inputs`` (drawn after the prompt
    when not given), at every decode step, as the reference reuses one key.
    Returns the (batch, gen) tokens and the times.

    With ``mesh`` (every rank calling with the same arguments) each rank
    keeps its shards of the params (TP and EP split, replicated over DP),
    runs its rows of the batch (``common.constrain_batch``) against caches
    of its rows and KV heads (``sharding.cache_specs``), and the tokens
    come back whole.  A batch the data axes do not divide runs whole on
    every data rank against a sequence-split cache (``meshctx.split_seq``:
    each rank holds a segment of every sequence's positions).  Calibration
    runs on the whole batch before the params are split.

    ``plan_report`` prints the resolved site table first (which boundaries
    are digital and which time-chained)."""
    device = common.resolve_device(device)
    if plan_report:
        print_plan(cfg)
    if params is None:
        params = model.init_params(seed, cfg, device=device)
    embeds = cfg.input_mode == "embeddings"
    g = torch.Generator().manual_seed(seed)
    if prompts is None:
        prompts = (torch.randn((batch, prompt_len, cfg.d_model), generator=g)
                   if embeds else
                   torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                 generator=g))
    prompts = torch.as_tensor(prompts).to(device)
    batch, prompt_len = prompts.shape[:2]
    if embeds:
        if decode_inputs is None:
            decode_inputs = torch.randn((batch, 1, cfg.d_model), generator=g)
        decode_inputs = torch.as_tensor(decode_inputs).to(device)
        if tuple(decode_inputs.shape) != (batch, 1, cfg.d_model):
            raise ValueError(f"decode_inputs: want {(batch, 1, cfg.d_model)}, "
                             f"got {tuple(decode_inputs.shape)}")
    elif decode_inputs is not None:
        raise ValueError(f"{cfg.name} takes tokens: its decode steps feed "
                         "back the sampled token, not decode_inputs")
    with torch.no_grad():
        if calibrate and calib is None:
            calib = model.calibrate(params, {"inputs": prompts}, cfg,
                                    max_len=prompt_len + gen, device=device)
        if mesh is not None:
            params, prompts, decode_inputs, caches = _shard_static(
                cfg, params, prompts, decode_inputs, prompt_len + gen,
                mesh, device)
        else:
            caches = model.init_caches(cfg, batch, prompt_len + gen, device)
        split = prompts.shape[0] != batch     # rows split over the data axes
        _sync(device)
        t0 = time.perf_counter()
        with _on_mesh(mesh, split):
            logits, caches = model.prefill_step(params, {"inputs": prompts},
                                                caches, cfg, calib=calib)
        tok = torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]
        _sync(device)
        t_prefill = time.perf_counter() - t0
        # counted on the device and read once, after the timed loop
        out, nan_steps = [tok], torch.isnan(logits).any().to(torch.int32)
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            with _on_mesh(mesh, split):
                logits, caches = model.decode_step(
                    params, {"inputs": decode_inputs if embeds else tok},
                    caches, cfg, calib=calib)
            nan_steps = nan_steps + torch.isnan(logits).any()
            tok = torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]
            out.append(tok)
        _sync(device)
        t_decode = time.perf_counter() - t0
        tokens = torch.cat(out, dim=1)
        with _on_mesh(mesh, split):
            tokens = meshctx.dp_gather(tokens, batch)
    return {
        "tokens": tokens.cpu(),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
        "nan_steps": int(nan_steps),
        "calibration": calib,
    }


@contextlib.contextmanager
def _on_mesh(mesh, split: bool):
    """The mesh installed, and the rows marked split over its data axes, or
    (when they are not) the dense caches sequence-split over them."""
    with meshctx.use_mesh_of(mesh), meshctx.split_rows(split), \
            meshctx.split_seq(not split):
        yield


def _shard_static(cfg, params, prompts, decode_inputs, max_len: int, mesh,
                  device):
    """This rank's params, batch rows and caches for ``serve_static``."""
    dp = axis_info(mesh)["dp_axes"]
    batch = prompts.shape[0]
    p_specs = sharding.param_specs(params, cfg, mesh, dp_axes=(), ep_axes=dp)
    params = sharding.shard_tree(params, p_specs, mesh)
    with meshctx.use_mesh_of(mesh):
        prompts = common.constrain_batch(prompts)
        if decode_inputs is not None:
            decode_inputs = common.constrain_batch(decode_inputs)
    caches = steps.init_serving_caches(cfg, batch, max_len, device, mesh)
    # the caches are this rank's shards under cache_specs: its rows, or a
    # batch the data axes do not divide whole with its segment of the
    # sequence; its KV heads (or lanes), SSM heads and conv channels
    if prompts.shape[0] == batch:
        n = meshctx.axis_size(dp, mesh)
        max_len = -(-max_len // n) * n
    whole = model.init_caches(cfg, batch, max_len, torch.device("meta"))
    specs = dict(leaves_with_paths(sharding.cache_specs(whole, cfg, mesh)))
    for (name, t), (_, w) in zip(leaves_with_paths(caches),
                                 leaves_with_paths(whole)):
        if name.endswith("/pos"):
            # whole (L, B) in the JAX package; here the rank's rows'
            continue
        want = sharding.local_shape(tuple(w.shape), specs[name], mesh)
        if tuple(t.shape) != want:
            raise ValueError(f"cache {name}: {tuple(t.shape)} is not "
                             f"the shard {want} of {tuple(w.shape)}")
    return params, prompts, decode_inputs, caches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--static", action="store_true",
                    help="uniform batch: one prefill + greedy decode steps "
                         "(the only path for SSM, hybrid and sliding-window "
                         "archs)")
    ap.add_argument("--batch", type=int, default=4,
                    help="--static: sequences in the batch")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family model (2 layers, d_model 64)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16,
                    help="new tokens per request (--static: per sequence)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calibrate", action="store_true",
                    help="pin every TD-VMM site's readout window with one "
                         "calibration pass before serving (needed whenever "
                         "--tdvmm enables a site)")
    ap.add_argument("--plan-report", action="store_true",
                    help="print the resolved TD-VMM site table")
    ap.add_argument("--tdvmm", default=None, metavar="PATTERN",
                    help="run the plan sites matching PATTERN (e.g. 'ffn.*') "
                         "as analog TD-VMM tiles")
    ap.add_argument("--chain", action="store_true",
                    help="time-domain chain ffn.in -> ffn.out (no "
                         "intermediate p-bit readout)")
    ap.add_argument("--kv-int8", action="store_true",
                    help="store the KV caches as int8 codes with per-(token, "
                         "head) scales")
    ap.add_argument("--mesh", default=None, metavar="DxT",
                    help="serve on a (data, model) mesh of D x T processes "
                         "(start them with python -m torch.distributed.run "
                         "--nproc-per-node D*T)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain path)")
    # fault tolerance and drift (engine path)
    ap.add_argument("--snapshot-dir", default=None,
                    help="preemption snapshots go here; also installs "
                         "SIGTERM/SIGINT handlers")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest engine snapshot from "
                         "--snapshot-dir and continue the trace")
    ap.add_argument("--preempt-at", type=int, default=None,
                    help="inject a preemption at this engine step")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a step failure at this engine step")
    ap.add_argument("--fail-kind", default="any",
                    choices=["prefill", "decode", "any"])
    ap.add_argument("--fail-times", type=int, default=1,
                    help="how many raises (<= --retries: transient; "
                         "--retries + 1: persistent, one request fails)")
    ap.add_argument("--drift-at", type=int, default=None,
                    help="perturb the device currents (FG tuning drift) at "
                         "this engine step")
    ap.add_argument("--drift-sigma", type=float, default=0.5)
    ap.add_argument("--slow-at", type=int, default=None,
                    help="inject a one-step straggler at this engine step")
    ap.add_argument("--slow-sleep", type=float, default=0.25,
                    help="seconds the injected straggler step sleeps")
    ap.add_argument("--retries", type=int, default=2,
                    help="retry budget per step")
    ap.add_argument("--heartbeat", default=None,
                    help="liveness marker file path")
    ap.add_argument("--heartbeat-every", type=float, default=30.0)
    ap.add_argument("--drift-check-every", type=int, default=0,
                    help="probe the windows for drift every N engine steps "
                         "(0 = off; requires --calibrate)")
    ap.add_argument("--drift-tol", type=float, default=0.25,
                    help="max |log window ratio| before recalibrating")
    ap.add_argument("--drift-clip", type=float, default=0.01,
                    help="max readout clip rate before recalibrating")
    ap.add_argument("--clip-observe-every", type=int, default=0,
                    help="stream the per-site readout clip rates into the "
                         "metrics sink every N engine steps as "
                         "clip_rate.<site> series (0 = off; requires "
                         "--calibrate, --tdvmm and a sink: --metrics-jsonl "
                         "or --alert-on, e.g. "
                         "'clip_rate.ffn.out:threshold:limit=0.01')")
    # SLA scheduling, telemetry and tracing (engine path)
    ap.add_argument("--sla", action="store_true",
                    help="SLA admission: priority with aging (the trace's "
                         "priorities cycle rid %% 3), deadline and joule "
                         "admission control, over-budget finishing")
    ap.add_argument("--aging-steps", type=int, default=16,
                    help="queue-wait steps per priority level of aging")
    ap.add_argument("--deadline-steps", type=int, default=None,
                    help="per-request deadline (engine steps after "
                         "arrival) stamped on every trace request")
    ap.add_argument("--joule-budget", type=float, default=None,
                    help="per-request analog energy budget in joules "
                         "stamped on every trace request")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="stream per-tick metrics and alerts to this JSONL "
                         "file (enables the metrics sink)")
    ap.add_argument("--alert-on", action="append", default=None,
                    metavar="METRIC:KIND[:K=V,...]",
                    help="alert rule, e.g. "
                         "step_latency_s:spike:k=6,abs_floor=0.05 or "
                         "fj_per_op:regression:baseline=57.1,tol=0.1 "
                         "(repeatable; enables the metrics sink)")
    ap.add_argument("--trace-out", default=None,
                    help="write the request lifecycle as a Chrome-trace "
                         "(Perfetto) JSON here; its spans ride engine "
                         "snapshots, so a --resume run continues it")
    ap.add_argument("--report-json", default=None,
                    help="write the whole EngineReport here as JSON")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_cfg(cfg)
    rules = []
    if args.tdvmm:
        rules.append(tdvmm_rule(args.tdvmm, enabled=True))
    if args.chain:
        rules.append(tdvmm_rule("ffn.in", chain=True))
    if rules:
        cfg = cfg.replace(tdvmm_plan=TDVMMPlan(rules=tuple(rules)))
    mesh = None
    if args.mesh:
        _, _, device = mesh_lib.init_distributed(args.device)
        args.device = str(device)
        mesh = mesh_lib.parse_mesh(args.mesh, device.type)
    attention.set_kv_cache_int8(args.kv_int8)
    try:
        if not args.static:
            return serve_engine(cfg, args, mesh=mesh)
        out = serve_static(cfg, args.batch, args.prompt_len, args.gen,
                           seed=args.seed, calibrate=args.calibrate,
                           device=args.device, mesh=mesh,
                           plan_report=args.plan_report)
    finally:
        attention.set_kv_cache_int8(False)
    print(f"[serve] {args.arch} batch={args.batch} "
          f"prefill={out['prefill_s']:.3f}s decode={out['decode_s']:.3f}s "
          f"({out['decode_tok_per_s']:.1f} tok/s)")
    if out["calibration"] is not None:
        print(f"[serve] calibrated sites: {out['calibration'].sites()}")
    print("[serve] sample:", out["tokens"][0, :12].tolist())


if __name__ == "__main__":
    main()
