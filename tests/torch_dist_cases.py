"""The port's gloo-world test harness (tests/test_torch_dist_*): ``World``,
a world of spawned CPU processes kept across calls, and the per-rank cases
it runs, module-level functions of torch and the port only; the JAX side
of each comparison runs in the test process and reaches a case as numpy
arrays."""
from __future__ import annotations

import dataclasses
import os
import queue
import tempfile
import traceback
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import TDVMMLayerConfig, TDVMMPlan, tdvmm_rule
from repro_torch.configs import get_config, smoke
from repro_torch.core import calibration, layers, quant
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import meshctx, sharding
from repro_torch.models import common, model
from repro_torch.tree import leaves_with_paths

import torch.distributed as dist


# --------------------------------------------------------------------------
# A spawned world of processes (gloo on the CPU)
# --------------------------------------------------------------------------
def _worker(rank: int, world: int, init_file: str, backend: str,
            tasks, results) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args = task
            try:
                results.put((rank, True, fn(*args)))
            except BaseException:             # reported to the caller
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    """``nprocs`` spawned processes joined in one process group, kept alive
    across ``run`` calls.  ``run(fn, *args)`` calls ``fn(*args)`` on every
    rank (a module-level function: it is pickled by name) and returns the
    ranks' results in rank order; a rank that raises makes ``run`` raise
    with its traceback, and a run that takes longer than ``timeout``
    seconds kills the world and raises ``TimeoutError``.  ``close`` (or
    the ``with`` block's end) stops every process."""

    def __init__(self, nprocs: int, timeout: float = 120.0,
                 backend: str = "gloo"):
        import torch.multiprocessing as mp
        self.nprocs = nprocs
        self.timeout = timeout
        ctx = mp.get_context("spawn")
        self._dir = tempfile.TemporaryDirectory(prefix="repro_world_")
        init_file = os.path.join(self._dir.name, "init")
        self._tasks = [ctx.Queue() for _ in range(nprocs)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_worker, args=(
            r, nprocs, init_file, backend, self._tasks[r], self._results),
            daemon=True) for r in range(nprocs)]
        for p in self._procs:
            p.start()

    def run(self, fn: Callable, *args: Any) -> list:
        import time
        if not self._procs:
            raise RuntimeError("the world is closed")
        for q in self._tasks:
            q.put((fn, args))
        out: dict[int, Any] = {}
        errors: list[str] = []
        t0 = time.monotonic()
        failed_at = None
        while len(out) + len(errors) < self.nprocs:
            try:
                rank, ok, val = self._results.get(timeout=1.0)
            except queue.Empty:
                now = time.monotonic()
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive()]
                # once a rank has failed, the others may wait in a
                # collective that never completes: give them a moment
                if dead or (failed_at is not None and now - failed_at > 5):
                    self.close(kill=True)
                    raise RuntimeError("\n".join(errors) or
                                       f"ranks {dead} of the world died")
                if now - t0 > self.timeout:
                    self.close(kill=True)
                    raise TimeoutError(
                        f"{getattr(fn, '__name__', fn)} took over "
                        f"{self.timeout} s on a world of {self.nprocs}")
                continue
            if ok:
                out[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
                failed_at = time.monotonic()
        if errors:
            self.close(kill=True)
            raise RuntimeError("\n".join(errors))
        return [out[r] for r in range(self.nprocs)]

    def close(self, kill: bool = False) -> None:
        if not self._procs:
            return
        if not kill:
            for q in self._tasks:
                q.put(None)
            for p in self._procs:
                p.join(timeout=30)
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        self._procs = []
        self._dir.cleanup()

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.close(kill=exc[0] is not None)


def rank() -> int:
    return dist.get_rank()


def _chip_smoke():
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


def smoke_cfg(arch: str, plan_rules=()):
    """The smoke config of the JAX package's mesh tests: vocab padded to 32,
    MoE capacity 64 (no drops, so the per-shard capacity cannot move a
    token)."""
    cfg = smoke(get_config(arch)).replace(vocab_pad_multiple=32)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=64.0))
    if plan_rules:
        cfg = cfg.replace(tdvmm_plan=TDVMMPlan(rules=tuple(
            tdvmm_rule(p, enabled=True, backend="jnp") for p in plan_rules)))
    return cfg


def compute_specs(params, cfg, mesh):
    return sharding.param_specs(params, cfg, mesh, dp_axes=(),
                                ep_axes=meshlib.axis_info(mesh)["dp_axes"])


# --------------------------------------------------------------------------
# 2 x 2 forward
# --------------------------------------------------------------------------
def forward_2x2(arch: str, np_params: dict, tokens: np.ndarray,
                tp_explicit: bool = False, plan_rules=(), calib=None,
                shape=(2, 2)):
    """(meshless port logits, 2 x 2 (or ``shape``) logits, every rank's
    logits equal, the FSDP + TP shards gathered back bitwise)."""
    cfg = smoke_cfg(arch, plan_rules)
    params = convert.params_from_numpy(np_params, cfg, "cpu")
    toks = torch.from_numpy(tokens)
    fwd_cfg = calibration.apply_calibration(cfg, calib)
    ref, _ = model.forward(params, {"inputs": toks}, fwd_cfg)
    mesh = meshlib.make_test_mesh(*shape)
    # the training layout (FSDP + TP) round-trips exactly ...
    state_specs = sharding.param_specs(params, cfg, mesh)
    shards = sharding.shard_tree(params, state_specs, mesh)
    back = sharding.gather_tree(shards, state_specs, mesh)
    exact = all(torch.equal(a, b) for (_, a), (_, b) in
                zip(leaves_with_paths(params), leaves_with_paths(back)))
    # ... and the step runs on the compute layout (TP + EP, FSDP gathered)
    specs = compute_specs(params, cfg, mesh)
    local = sharding.regather(shards, state_specs, specs, mesh)
    direct = sharding.shard_tree(params, specs, mesh)
    exact = exact and all(torch.equal(a, b) for (_, a), (_, b) in zip(
        leaves_with_paths(local), leaves_with_paths(direct)))
    common.set_tp_explicit(tp_explicit)
    try:
        with meshctx.use_mesh_of(mesh):
            out, aux = model.forward(local, {"inputs": toks}, fwd_cfg)
    finally:
        common.set_tp_explicit(False)
    every = meshctx.all_gather(out[None], dist.group.WORLD, 0)
    agree = all(torch.equal(every[0], e) for e in every)
    return {"ref": ref.numpy(), "out": out.numpy(), "agree": agree,
            "exact": exact,
            "aux": {k: float(v) for k, v in aux.items()}}


# --------------------------------------------------------------------------
# TD-VMM sites on a tensor-parallel shard, against the meshless site
# --------------------------------------------------------------------------
def _site(site: str, **kw) -> TDVMMLayerConfig:
    return TDVMMLayerConfig(enabled=True, backend="jnp", site=site, **kw)


def td_sites_2x2(seed: int):
    """Every kind of TD-VMM site on its model-axis shard of a 2 x 2 mesh
    against the meshless site on the whole operands: outputs, recorded
    windows and clip tallies must be bitwise equal.  Returns the names of
    the cases that differ (empty when all hold) and the number held."""
    mesh = meshlib.make_test_mesh(2, 2)
    g = torch.Generator().manual_seed(seed)
    m, k, n, e = 24, 96, 80, 4
    x = torch.randn((3, m // 3, k), generator=g)
    w = torch.randn((k, n), generator=g) * 0.2
    xe = torch.randn((e, m, k), generator=g)
    we = torch.randn((e, k, n), generator=g) * 0.2
    ws = [torch.randn((k, wd), generator=g) for wd in (64, 32, 32)]
    bad, held = [], 0
    tp, r = 2, mesh.get_local_rank("model")

    def cols(t, dim=-1):
        return t.chunk(tp, dim=dim)[r]

    def check(name, got, want):
        nonlocal held
        if not torch.equal(got, want):
            bad.append(name)
        held += 1

    win = {"ffn.in": torch.tensor(0.02), "ffn.out": torch.tensor(0.03),
           "moe.expert.in": torch.tensor([0.02, 0.03, 0.025, 0.04]),
           "moe.expert.out": torch.tensor([0.05, 0.02, 0.03, 0.035]),
           "attn.qkv": torch.tensor([0.02, 0.03, 0.04])}
    for label, kw in (("data", {}), ("pinned", "runtime"),
                      ("noreadout", {"io_quantize": False}),
                      ("pertensor", {"per_channel": False}),
                      ("p8", {"bits": 8, "weight_bits": 8})):
        extra = {} if kw == "runtime" else kw
        ctx = calibration.runtime_windows(win if kw == "runtime" else None)
        with ctx:
            # column site: N split
            cfg = _site("ffn.in", **extra)
            want = layers.td_matmul(x, w, cfg)
            with meshctx.use_mesh_of(mesh):
                got = layers.td_matmul(x, cols(w), cfg, tp="col")
            check(f"col/{label}", got, cols(want))
            # row site: K split
            cfg = _site("ffn.out", **extra)
            want = layers.td_matmul(x, w, cfg)
            with meshctx.use_mesh_of(mesh):
                got = layers.td_matmul(cols(x), cols(w, 0), cfg, tp="row")
            check(f"row/{label}", got, want)
            # expert bank, column then row
            cfg = _site("moe.expert.in", **extra)
            want = layers.td_expert_matmul(xe, we, cfg)
            with meshctx.use_mesh_of(mesh):
                got = layers.td_expert_matmul(xe, cols(we), cfg, tp="col")
            check(f"expert-col/{label}", got, cols(want))
            cfg = _site("moe.expert.out", **extra)
            want = layers.td_expert_matmul(xe, we, cfg)
            with meshctx.use_mesh_of(mesh):
                got = layers.td_expert_matmul(cols(xe), cols(we, 1), cfg,
                                              tp="row")
            check(f"expert-row/{label}", got, want)
            # grouped (attn.qkv): every member's columns split
            cfg = _site("attn.qkv", **extra)
            want = layers.td_grouped_matmul(x, ws, cfg)
            with meshctx.use_mesh_of(mesh):
                got = layers.td_grouped_matmul(x, [cols(t) for t in ws], cfg,
                                               tp="col")
            for i, (a, b) in enumerate(zip(got, want)):
                check(f"grouped{i}/{label}", a, cols(b))
    # codes: a row site's input codes are the slices of the whole row's
    qx = quant.encode_input(x, 6)
    with meshctx.use_mesh_of(mesh):
        qx_loc = quant.encode_input(cols(x), 6, tp_reduce=True)
        qw_loc = quant.program_weights(cols(w, 0), 6, True, tp_reduce=True)
    qw = quant.program_weights(w, 6, True)
    check("codes/x", qx_loc.codes, cols(qx.codes))
    check("codes/x-scale", qx_loc.scale, qx.scale)
    check("codes/w", qw_loc.codes, cols(qw.codes, 0))
    check("codes/w-scale", qw_loc.scale, qw.scale)
    # calibration capture and clip tallies
    pinned = {"ffn.in": torch.tensor(0.01), "ffn.out": torch.tensor(0.01),
              "moe.expert.in": torch.full((e,), 0.01),
              "moe.expert.out": torch.full((e,), 0.01),
              "attn.qkv": torch.full((3,), 0.01)}

    def capture(tp_run: bool):
        with calibration.collect(pinned=pinned) as got:
            if tp_run:
                with meshctx.use_mesh_of(mesh):
                    layers.td_matmul(x, cols(w), _site("ffn.in"), tp="col")
                    layers.td_matmul(cols(x), cols(w, 0), _site("ffn.out"),
                                     tp="row")
                    layers.td_expert_matmul(xe, cols(we),
                                            _site("moe.expert.in"), tp="col")
                    layers.td_expert_matmul(cols(xe), cols(we, 1),
                                            _site("moe.expert.out"), tp="row")
                    layers.td_grouped_matmul(x, [cols(t) for t in ws],
                                             _site("attn.qkv"), tp="col")
            else:
                layers.td_matmul(x, w, _site("ffn.in"))
                layers.td_matmul(x, w, _site("ffn.out"))
                layers.td_expert_matmul(xe, we, _site("moe.expert.in"))
                layers.td_expert_matmul(xe, we, _site("moe.expert.out"))
                layers.td_grouped_matmul(x, ws, _site("attn.qkv"))
        clips = calibration.last_clips() or {}
        return dict(got), {s: np.asarray(v).tolist()
                           for s, v in clips.items()}
    w_tp, c_tp = capture(True)
    w_ref, c_ref = capture(False)
    for site in w_ref:
        check(f"capture/{site}", torch.from_numpy(np.asarray(w_tp[site])),
              torch.from_numpy(np.asarray(w_ref[site])))
    if c_tp != c_ref:
        bad.append(f"clips {c_tp} != {c_ref}")
    return {"bad": bad, "held": held}


# --------------------------------------------------------------------------
# Elastic restore: save on 2 x 2, restore on 4 x 1
# --------------------------------------------------------------------------
def elastic_restore(directory: str):
    from repro_torch.checkpoint import checkpoint as ckpt
    cfg = smoke_cfg("yi-34b")
    params = model.init_params(5, cfg, device="cpu")
    mesh_a = meshlib.make_test_mesh(2, 2)
    spec_a = sharding.param_specs(params, cfg, mesh_a)
    shards_a = sharding.shard_tree(params, spec_a, mesh_a)
    whole = sharding.gather_tree(shards_a, spec_a, mesh_a)
    if rank() == 0:
        ckpt.save(whole, directory, step=3)
    dist.barrier()
    mesh_b = meshlib.make_test_mesh(4, 1)
    spec_b = sharding.param_specs(params, cfg, mesh_b)
    like = sharding.shard_tree(params, spec_b, mesh_b)
    like = {k: v for k, v in like.items()}
    restored, step = ckpt.restore(like, directory,
                                  shardings=(spec_b, mesh_b))
    back = sharding.gather_tree(restored, spec_b, mesh_b)
    n_split = sum(any(a is not None for a in s)
                  for _, s in leaves_with_paths(spec_b))
    return {"step": step, "n_split": n_split,
            "exact": all(torch.equal(a, b) for (_, a), (_, b) in zip(
                leaves_with_paths(params), leaves_with_paths(back))),
            "shards_exact": all(torch.equal(a, b) for (_, a), (_, b) in zip(
                leaves_with_paths(restored), leaves_with_paths(
                    sharding.shard_tree(params, spec_b, mesh_b))))}


# --------------------------------------------------------------------------
# int8 error-feedback all-reduce over 4 ranks
# --------------------------------------------------------------------------
def compressed_reduce(iters: int = 50):
    from repro_torch.optim import compression
    g = torch.Generator().manual_seed(100 + rank())
    x = torch.randn((3000,), generator=g) * 1e-3
    true = x.clone()
    dist.all_reduce(true)
    true /= dist.get_world_size()
    plain = torch.zeros_like(x)
    ef = torch.zeros_like(x)
    residual = None
    errs = []
    for i in range(iters):
        y, _ = compression.compressed_all_reduce(x, None, None)
        plain += y
        y, residual = compression.compressed_all_reduce(x, None, residual)
        ef += y
        errs.append(float(torch.linalg.norm(ef / (i + 1) - true)))
    return {"err_plain": float(torch.linalg.norm(plain / iters - true)),
            "err_ef": errs[-1], "err_first": errs[0],
            "ef": (ef / iters).numpy()}


def compressed_reduce_exchange(sizes: tuple):
    """``compressed_all_reduce``'s reduce-scatter + all-gather against the
    plain formulation on the same codes (every rank's codes and scales
    all-gathered, dequantized and summed in rank order): equal?"""
    from repro_torch.optim import compression
    n = dist.get_world_size()
    out = []
    for size in sizes:
        g = torch.Generator().manual_seed(10 * rank() + size)
        x = torch.randn((size,), generator=g)
        residual = torch.randn((size,), generator=g) * 1e-3
        y, _ = compression.compressed_all_reduce(x, None, residual)
        codes, scale = compression._quantize_int8(x + residual)
        all_codes = [torch.empty_like(codes) for _ in range(n)]
        all_scales = [torch.empty_like(scale) for _ in range(n)]
        dist.all_gather(all_codes, codes)
        dist.all_gather(all_scales, scale)
        summed = all_codes[0].float() * all_scales[0]
        for c, s_ in zip(all_codes[1:], all_scales[1:]):
            summed = summed + c.float() * s_
        out.append(bool(torch.equal(
            y, (summed / float(n)).reshape(-1)[:size])))
    return out


# --------------------------------------------------------------------------
# Training on 2 x 2
# --------------------------------------------------------------------------
def _train_run(arch: str, np_params: dict, shape: dict, opt: dict,
               directory: str, compression: str):
    """A RunConfig whose ``train_loop`` starts from ``np_params``."""
    from repro_torch.configs import OptimizerConfig, RunConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    cfg = smoke(get_config(arch))
    params = convert.params_from_numpy(np_params, cfg, "cpu")

    def init_state(seed, cfg_, optimizer, device=None):
        p = {k: v for k, v in params.items()}
        return steps.TrainState(p, optimizer.init(p))
    steps.init_train_state = init_state
    return RunConfig(model=cfg, shape=ShapeConfig(**shape),
                     optimizer=OptimizerConfig(
                         **opt, grad_compression=compression),
                     checkpoint_dir=directory)


def train_2x2(arch: str, np_params: dict, shape: dict, opt: dict,
              directory: str, compression: str = "none"):
    from repro_torch.launch import train
    run = _train_run(arch, np_params, shape, opt, directory, compression)
    mesh = meshlib.make_test_mesh(2, 2)
    out = train.train_loop(run, 3, log_every=1, device="cpu", mesh=mesh)
    return {"history": out["history"], "step": out["step"]}


def train_2x2_resume(arch: str, np_params: dict, shape: dict, opt: dict,
                     directory: str):
    """Under the int8 all-reduce: 3 steps unbroken, and 2 steps then a
    fresh ``train_loop`` that resumes from the checkpoint to step 3.
    Returns both runs' step-2 metrics and final checkpoints (numpy)."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.launch import train
    mesh = meshlib.make_test_mesh(2, 2)
    out = {}
    for name, stops in (("unbroken", (3,)), ("resumed", (2, 3))):
        run = _train_run(arch, np_params, shape, opt,
                         os.path.join(directory, name), "int8")
        for stop in stops:
            hist = train.train_loop(run, stop, log_every=1, device="cpu",
                                    mesh=mesh)["history"]
        leaves, _ = ckpt.load_flat(run.checkpoint_dir)
        out[name] = {"last": {k: v for k, v in hist[-1].items()
                              if k != "dt"},
                     "ckpt": {k: v.float().numpy() for k, v in
                              leaves.items()}}
    return out


def ep_train_grads(arch: str, shape: tuple):
    """One training step's gradients on a mesh of ``shape``, gathered
    whole, against the meshless step's: the largest per-leaf gap over the
    leaf's max|g|, and the leaf.  The aux losses' coefficients are 0: a data
    shard's load-balance loss is its own rows' (the JAX package averages
    the shards' aux losses), not the global batch's."""
    import functools
    from repro_torch.configs import OptimizerConfig, RunConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, make_pipeline
    from repro_torch.launch import steps
    from repro_torch.optim import optimizer as om
    cfg = smoke_cfg(arch)
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "small", 16, 4, "train", microbatch_per_shard=4),
        optimizer=OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=3))
    opt = om.make_optimizer(run.optimizer)
    got = []
    update, loss_fn = om.Optimizer.update, model.loss_fn

    def spy(self, grads, *a, **kw):
        got.append(grads)
        return update(self, grads, *a, **kw)
    om.Optimizer.update = spy
    model.loss_fn = functools.partial(loss_fn, lb_coef=0.0, z_coef=0.0)
    try:
        state = model.init_params(0, cfg, device="cpu")
        state = steps.TrainState(state, opt.init(state))
        batch = make_pipeline(cfg, run.shape, DataConfig(seed=0)).batch_at(0)
        steps.make_train_step(cfg, run, opt)(state, batch)
        mesh = meshlib.make_test_mesh(*shape)
        specs = steps.state_specs(state, cfg, mesh)
        steps.make_train_step(cfg, run, opt, mesh=mesh, specs=specs)(
            steps.shard_state(state, cfg, mesh), batch)
    finally:
        om.Optimizer.update, model.loss_fn = update, loss_fn
    whole = sharding.gather_tree(got[1], specs[0].params, mesh)
    return max((float((a - b).abs().max() / a.abs().max()), p)
               for (p, a), (_, b) in zip(leaves_with_paths(got[0]),
                                         leaves_with_paths(whole)))


# --------------------------------------------------------------------------
# Engines
# --------------------------------------------------------------------------
def engine_trace(cfg):
    """The JAX package's mesh kill/restore trace (tests/test_fault.py)."""
    from repro_torch.runtime.engine import Request
    rng = np.random.default_rng(0)
    reqs, arrival = [], 0
    for rid in range(4):
        reqs.append(Request(
            rid=rid, prompt=tuple(int(t) for t in rng.integers(
                0, cfg.vocab_size, rng.integers(3, 11))),
            max_new_tokens=int(rng.integers(2, 6)),
            arrival_step=arrival, priority=rid % 3))
        arrival += int(rng.integers(0, 2))
    return reqs


def engine_kill_restore(np_params: dict, windows: dict, slots: int,
                        kill: int, mesh_shape, spread: bool = False):
    """The kill/restore contract of tests/test_fault.py's mesh test on one
    layout: an unbroken run, a run preempted at step ``kill``, its snapshot
    restored into a fresh engine and resumed.  ``spread``: a trace busy
    enough to use every data rank's slots."""
    from repro_torch.runtime import faultinject as fi
    from repro_torch.runtime.engine import (Engine, EngineConfig,
                                            FaultConfig, Request)
    from repro_torch.runtime.sla import SlaConfig
    from repro_torch.runtime.telemetry import MetricsSink
    cfg = smoke_cfg("qwen1.5-0.5b", ("ffn.*",)).replace(vocab_pad_multiple=16)
    params = convert.params_from_numpy(np_params, cfg, "cpu")
    calib = calibration.CalibrationState(windows={
        k: torch.as_tensor(v) for k, v in windows.items()})
    ecfg = EngineConfig(slots=slots, page_size=4, num_pages=32, chunk=4)
    sla = SlaConfig(aging_steps=8)
    reqs = engine_trace(cfg)
    e_tok = Engine(cfg, params, ecfg, calib=calib,
                   device="cpu").energy["energy_per_token_j"]
    reqs.append(Request(rid=900, prompt=tuple(range(1, 9)),
                        max_new_tokens=20, deadline_steps=1, arrival_step=1))
    reqs.append(Request(rid=901, prompt=tuple(range(9, 15)),
                        max_new_tokens=6, arrival_step=2,
                        joule_budget=(6 + 2.5) * e_tok))
    if spread:
        rng = np.random.default_rng(7)
        reqs += [Request(rid=100 + i, prompt=tuple(int(t) for t in
                                                   rng.integers(0, 500, 6)),
                         max_new_tokens=8, arrival_step=0)
                 for i in range(4)]
    mesh = meshlib.make_test_mesh(*mesh_shape) if mesh_shape else None

    def eng():
        return Engine(cfg, params, ecfg, calib=calib, sla=sla,
                      sink=MetricsSink(), device="cpu", mesh=mesh)

    def streams(rep):
        return [[q["rid"], q["tokens"], q["finish_reason"],
                 q["finished_step"]] for q in rep.requests]

    def strip(snap):
        snap = dict(snap)
        snap["series"] = {k: v for k, v in snap["series"].items()
                          if k != "step_latency_s"}
        return snap
    base = eng().run(reqs)
    victim = eng()
    rep = victim.run(reqs, FaultConfig(
        injector=fi.FaultInjector([fi.PreemptAt(kill)])))
    snap = victim.snapshot()
    survivor = eng()
    survivor.restore(snap)
    at_restore = strip(survivor.sink.snapshot())
    resumed = survivor.resume()
    import json
    meta = json.loads(bytes(snap["meta"].numpy()).decode("utf-8"))
    return {"base": streams(base), "resumed": streams(resumed),
            "base_steps": base.steps, "resumed_steps": resumed.steps,
            "preempted": rep.preempted and rep.steps == kill,
            "rejected": resumed.rejected, "over_budget": resumed.over_budget,
            "sink_at_restore": at_restore,
            "step_shapes": survivor.report().step_shapes,
            "devices": resumed.devices, "total_slots": resumed.total_slots,
            "page_high_water": base.page_high_water,
            "snap_dp": meta["dp"], "snap_free_lists": len(meta["pool"]["free"]),
            "utilization": base.utilization}


def engine_dp_mismatch(np_params: dict, windows: dict):
    """A snapshot of a dp-2 engine restores onto a dp-2 engine and is
    refused by a dp-1 one (here: a 1 x 4 mesh)."""
    from repro_torch.runtime.engine import Engine, EngineConfig
    cfg = smoke_cfg("qwen1.5-0.5b", ("ffn.*",)).replace(vocab_pad_multiple=16)
    params = convert.params_from_numpy(np_params, cfg, "cpu")
    calib = calibration.CalibrationState(windows={
        k: torch.as_tensor(v) for k, v in windows.items()})
    ecfg = EngineConfig(slots=2, page_size=4, num_pages=16, chunk=4)
    reqs = engine_trace(cfg)
    dp2 = meshlib.make_test_mesh(2, 2)
    a = Engine(cfg, params, ecfg, calib=calib, device="cpu", mesh=dp2)
    a.start(reqs)
    for _ in range(5):
        a.tick()
    snap = a.snapshot()
    b = Engine(cfg, params, ecfg, calib=calib, device="cpu", mesh=dp2)
    b.restore(snap)
    ok = b.resume().requests == a.resume().requests
    other = Engine(cfg, params, ecfg, calib=calib, device="cpu",
                   mesh=meshlib.make_test_mesh(1, 4))
    try:
        other.restore(snap)
        refused = ""
    except ValueError as e:
        refused = str(e)
    return {"same": ok, "refused": refused}


def world_of_one(np_params: dict, windows: dict, reqs_spec: dict,
                 train_np_params: dict, shape: dict, opt: dict,
                 directory: str):
    """On a (1, 1) mesh (a world of one): the engine and one training step
    against the meshless port, bitwise."""
    from repro_torch.configs import OptimizerConfig, RunConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.optim.optimizer import make_optimizer
    from repro_torch.runtime.engine import Engine, EngineConfig, Request
    cfg = smoke_cfg("qwen1.5-0.5b", ("ffn.*",)).replace(vocab_pad_multiple=16)
    params = convert.params_from_numpy(np_params, cfg, "cpu")
    calib = calibration.CalibrationState(windows={
        k: torch.as_tensor(v) for k, v in windows.items()})
    ecfg = EngineConfig(**reqs_spec["ecfg"])
    reqs = [Request(**r) for r in reqs_spec["requests"]]
    mesh = meshlib.make_test_mesh(1, 1)
    base = Engine(cfg, params, ecfg, calib=calib, device="cpu").run(reqs)
    eng = Engine(cfg, params, ecfg, calib=calib, device="cpu", mesh=mesh)
    meshed = eng.run(reqs)
    import json
    meta = json.loads(bytes(eng.snapshot()["meta"].numpy()).decode("utf-8"))
    engine = {"base": [[q["rid"], q["tokens"], q["finish_reason"],
                        q["finished_step"]] for q in base.requests],
              "meshed": [[q["rid"], q["tokens"], q["finish_reason"],
                          q["finished_step"]] for q in meshed.requests],
              "steps": (base.steps, meshed.steps),
              "page_high_water": (base.page_high_water,
                                  meshed.page_high_water),
              "step_shapes": meshed.step_shapes, "devices": meshed.devices,
              "total_slots": meshed.total_slots, "snap_dp": meta["dp"],
              "snap_free_lists": len(meta["pool"]["free"])}
    # one training step, meshless and on the (1, 1) mesh
    tcfg = smoke(get_config("qwen1.5-0.5b"))
    run = RunConfig(model=tcfg, shape=ShapeConfig(**shape),
                    optimizer=OptimizerConfig(**opt),
                    checkpoint_dir=directory)
    optimizer = make_optimizer(run.optimizer)
    tparams = convert.params_from_numpy(train_np_params, tcfg, "cpu")
    state = steps.TrainState(tparams, optimizer.init(tparams))
    g = np.random.default_rng(3)
    batch = {"inputs": g.integers(0, tcfg.vocab_size, (4, 16)),
             "targets": g.integers(0, tcfg.vocab_size, (4, 16))}
    one = steps.make_train_step(tcfg, run, optimizer)(state, batch)
    specs = steps.state_specs(state, tcfg, mesh)
    sharded = steps.shard_state(state, tcfg, mesh)
    two = steps.make_train_step(tcfg, run, optimizer, mesh=mesh,
                                specs=specs)(sharded, batch)
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        leaves_with_paths(one[0]), leaves_with_paths(two[0])))
    metrics = all(torch.equal(one[1][k], two[1][k]) for k in one[1])
    return {"engine": engine, "train_same": same, "train_metrics": metrics}


def pp_2x2x2(np_params: dict, tokens: np.ndarray, n_micro: int):
    from repro_torch.launch import pipeline
    cfg = smoke(get_config("yi-34b")).replace(n_layers=4)
    params = convert.params_from_numpy(np_params, cfg, "cpu")
    mesh = meshlib.make_mesh((2, 2, 2), meshlib.AXES_3D, "cpu")
    out = pipeline.pp_forward(params, torch.from_numpy(tokens), cfg, mesh,
                              n_micro=n_micro)
    return out.numpy()



def serve_cli_2x2(argv: list):
    """The serve CLI with ``--mesh 2x2`` on every rank (the world is already
    joined, as ``torch.distributed.run`` would have it)."""
    from repro_torch.launch import serve
    rep = serve.main(list(argv) + ["--mesh", "2x2"])
    return [[q["rid"], q["tokens"], q["finish_reason"], q["finished_step"]]
            for q in rep.requests], rep.devices, rep.total_slots


def serve_static_2x2(arch: str, calibrate: bool, batch: int):
    """``serve_static`` on a 2 x 2 mesh and without one, same seed."""
    from repro_torch.launch import serve
    cfg = smoke_cfg(arch, ("ffn.*",) if calibrate else ())
    solo = serve.serve_static(cfg, batch, 12, 5, seed=3, calibrate=calibrate,
                              device="cpu")
    mesh = meshlib.make_test_mesh(2, 2)
    out = serve.serve_static(cfg, batch, 12, 5, seed=3, calibrate=calibrate,
                             device="cpu", mesh=mesh)
    return solo["tokens"].numpy(), out["tokens"].numpy(), out["nan_steps"]


def count_cfg(arch: str):
    """The smoke config the dry run's check counts: every linear a 6-bit
    TD-VMM site (no product takes the card's float32-output route, so the
    CPU and the card count the same ops)."""
    cfg = smoke_cfg(arch)
    return cfg.replace(tdvmm=TDVMMLayerConfig(enabled=True, bits=6,
                                              weight_bits=6))


def count_step(arch: str, shape: dict, mesh_shape=(2, 2)):
    """``launch.dryrun.run_cell`` on real tensors in this world: the
    counts of one rank's step (``launch.roofline.StepCounter``)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    mesh = meshlib.make_test_mesh(*mesh_shape)
    with meshctx.use_mesh_of(mesh):
        r = dryrun.run_cell(count_cfg(arch), ShapeConfig(**shape), mesh)
    return r["counter"]


def tp_order_1x2(plan: bool, dtype: str):
    """The smoke qwen (2 layers) on 1 x 2 against the meshless model in
    TP's order (``chip_smoke.tp_order``, the control of the card's 1 x 2
    gate): teacher-forced logits (``chip_smoke.forced_logits``) and the
    engine's streams and finish steps, equal?  Also the logits' gap to the
    plain meshless run, over max|logit|."""
    from repro_torch.runtime.engine import Engine, EngineConfig
    cs = _chip_smoke()
    cfg = smoke(get_config("qwen1.5-0.5b")).replace(dtype=dtype, n_layers=2)
    if plan:
        cfg = cfg.replace(tdvmm_plan=cs.plans()["ffn_unchained"])
    params = model.init_params(0, cfg, device="cpu")
    g = torch.Generator().manual_seed(5)
    prompts = torch.randint(0, cfg.vocab_size, (4, 16), generator=g)
    calib = model.calibrate(params, {"inputs": prompts}, cfg,
                            device="cpu") if plan else None
    forced = torch.randint(0, cfg.vocab_size, (4, 5), generator=g)
    trace = cs.make_trace(cfg.vocab_size)[:4]
    ecfg = EngineConfig(slots=2, page_size=8, num_pages=64, chunk=16,
                        max_pages_per_slot=16)
    mesh = meshlib.make_test_mesh(1, 2)
    ref = cs.forced_logits(params, cfg, calib, prompts, forced, "cpu")
    got = cs.forced_logits(params, cfg, calib, prompts, forced, "cpu", mesh)
    with cs.tp_order(2):
        ctrl = cs.forced_logits(params, cfg, calib, prompts, forced, "cpu")
        want = Engine(cfg, params, ecfg, calib=calib, device="cpu").run(trace)
    have = Engine(cfg, params, ecfg, calib=calib, device="cpu",
                  mesh=mesh).run(trace)

    def streams(rep):
        return [(q["tokens"], q["finish_reason"], q["finished_step"])
                for q in rep.requests]
    return {"logits": all(torch.equal(a, b) for a, b in zip(got, ctrl)),
            "streams": streams(have) == streams(want),
            "gap": max(float((a - b).abs().max()) for a, b in zip(got, ref))
            / max(float(b.abs().max()) for b in ref)}


# --------------------------------------------------------------------------
# Placements of the production mesh: SSM / hybrid TP, the head-dim
# fallback, the sequence-split cache, TD-VMM training under TP
# --------------------------------------------------------------------------
def placement_cfg(arch: str, kv: int = 0, hd: int = 0):
    """``smoke_cfg``, with ``kv`` KV heads and a head dim of ``hd`` when
    given (the head-dim fallback's config: 2 KV heads do not divide a model
    axis of 4; the KV groups split's: 2 KV heads of 14 lanes at a model axis
    of 4, 14 not a multiple of 8, as kimi-k2's 112 is not of 32)."""
    cfg = smoke_cfg(arch)
    if kv:
        cfg = cfg.replace(n_kv_heads=kv)
    return cfg.replace(head_dim=hd) if hd else cfg


def forced_on_mesh(arch: str, np_params: dict, prompts: np.ndarray,
                   forced: np.ndarray, shape, kv: int = 0,
                   int8: bool = False, flash_block: int = 0,
                   order: str = "", hd: int = 0):
    """``chip_smoke.forced_logits`` on a mesh of ``shape`` (every step's
    teacher-forced logits, gathered whole): the static path's prefill and
    decode on its shards.  ``flash_block``: flash attention above that
    many tokens, in blocks of that size.  ``order`` "tp" / "seq": also the
    meshless run in the mesh's order (``chip_smoke.tp_order`` over the
    model axis, ``chip_smoke.seq_order`` over the data axis)."""
    from repro_torch.models import attention
    cs = _chip_smoke()
    cfg = placement_cfg(arch, kv, hd)
    params = convert.params_from_numpy(np_params, cfg, "cpu")
    old = (attention.FLASH_THRESHOLD, attention.FLASH_BLOCK_Q,
           attention.FLASH_BLOCK_KV)
    if flash_block:
        attention.FLASH_THRESHOLD = flash_block
        attention.FLASH_BLOCK_Q = attention.FLASH_BLOCK_KV = flash_block
    attention.set_kv_cache_int8(int8)
    try:
        args = (params, cfg, None, torch.from_numpy(prompts),
                torch.from_numpy(forced), "cpu")
        got = cs.forced_logits(*args, meshlib.make_test_mesh(*shape))
        ctrl = None
        if order:
            with (cs.tp_order(shape[1]) if order == "tp" else
                  cs.seq_order(shape[0])):
                ctrl = [x.numpy() for x in cs.forced_logits(*args)]
    finally:
        attention.set_kv_cache_int8(False)
        (attention.FLASH_THRESHOLD, attention.FLASH_BLOCK_Q,
         attention.FLASH_BLOCK_KV) = old
    return {"logits": [x.numpy() for x in got], "ctrl": ctrl}


def engine_on_mesh(np_params: dict, requests: list, ecfg: dict, shape,
                   kv: int, int8: bool, arch: str = "yi-34b", hd: int = 0):
    """The paged engine on a mesh of ``shape`` (the head-dim fallback's
    or the KV groups split's page pools): every request's stream and
    finish step."""
    from repro_torch.models import attention
    from repro_torch.runtime.engine import Engine, EngineConfig, Request
    cfg = placement_cfg(arch, kv, hd)
    params = convert.params_from_numpy(np_params, cfg, "cpu")
    attention.set_kv_cache_int8(int8)
    try:
        rep = Engine(cfg, params, EngineConfig(**ecfg), device="cpu",
                     mesh=meshlib.make_test_mesh(*shape)).run(
            [Request(**r) for r in requests])
    finally:
        attention.set_kv_cache_int8(False)
    return [[q["rid"], q["tokens"], q["finish_reason"], q["finished_step"]]
            for q in rep.requests]


def qat_cfg(noise: bool = False):
    """The smoke qwen with every linear a 6-bit TD-VMM site."""
    cfg = smoke(get_config("qwen1.5-0.5b"))
    return cfg.replace(tdvmm=TDVMMLayerConfig(enabled=True, bits=6,
                                              weight_bits=6, noise=noise))


def qat_grads_on_mesh(np_params: dict, batch: dict, shape, key=None):
    """One training step's gradients (through ``launch.steps``) of the
    QAT smoke qwen on a mesh of ``shape``, gathered whole, with the loss;
    with a noise ``key`` also the meshless step's."""
    from repro_torch.configs import OptimizerConfig, RunConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.optim import optimizer as om
    cfg = qat_cfg(key is not None)
    rows, seq = batch["inputs"].shape
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "small", seq, rows, "train", microbatch_per_shard=rows),
        optimizer=OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=3))
    opt = om.make_optimizer(run.optimizer)
    params = convert.params_from_numpy(np_params, cfg, "cpu")
    state = steps.TrainState(params, opt.init(params))
    got = []
    update = om.Optimizer.update

    def spy(self, grads, *a, **kw):
        got.append(grads)
        return update(self, grads, *a, **kw)
    om.Optimizer.update = spy
    try:
        out = {}
        if key is not None:
            _, m = steps.make_train_step(cfg, run, opt, key=key)(state, batch)
            out["meshless"] = {p: g.numpy() for p, g in
                               leaves_with_paths(got.pop())}
            out["meshless_loss"] = float(m["loss"])
        mesh = meshlib.make_test_mesh(*shape)
        specs = steps.state_specs(state, cfg, mesh)
        _, m = steps.make_train_step(cfg, run, opt, key=key, mesh=mesh,
                                     specs=specs)(
            steps.shard_state(state, cfg, mesh), batch)
    finally:
        om.Optimizer.update = update
    whole = sharding.gather_tree(got[0], specs[0].params, mesh)
    out["grads"] = {p: g.numpy() for p, g in leaves_with_paths(whole)}
    out["loss"] = float(m["loss"])
    return out


def noisy_codes_on_shards(seed: int, shape=(1, 4)):
    """Programming noise on a column, a row, an expert and a grouped
    site's shard (``layers._shard_noise``, ``layers._group_noise``) against
    the meshless noisy bank, sliced: bitwise?  Returns the names that
    differ and the number held."""
    from repro_torch.kernels.tdvmm import tdvmm
    mesh = meshlib.make_test_mesh(*shape)
    g = torch.Generator().manual_seed(seed)
    k, n, e = 64, 96, 3
    cfg = TDVMMLayerConfig(enabled=True, noise=True)
    w = torch.randn((k, n), generator=g)
    we = torch.randn((e, k, n), generator=g)
    ws = [torch.randn((k, wd), generator=g) for wd in (64, 32, 32)]
    key = 11 + seed
    bad, held = [], 0

    def check(name, got, want):
        nonlocal held
        if not torch.equal(got, want):
            bad.append(name)
        held += 1

    def whole(t):
        return quant.program_noise(quant.program_weights(t, 6, True),
                                   cfg.spec, key).codes
    with meshctx.use_mesh_of(mesh):
        tp, r = meshctx.tp_size(), meshctx.tp_rank()
        for name, full, dim, kind in (("col", w, -1, "col"),
                                      ("row", w, -2, "row"),
                                      ("expert-col", we, -1, "col"),
                                      ("expert-row", we, -2, "row")):
            local = full.chunk(tp, dim)[r]
            qw = quant.program_weights(local, 6, True,
                                       tp_reduce=kind == "row")
            got = layers._shard_noise(qw, cfg, key, kind).codes
            check(name, got, whole(full).chunk(tp, dim)[r])
        ns = tuple(t.shape[-1] // tp for t in ws)
        widths = tuple(tdvmm.padded_size(m, tdvmm.LANE, tdvmm.LANE)
                       for m in ns)
        qw = quant.concat_group([quant.program_weights(
            t.chunk(tp, -1)[r], 6, True) for t in ws], widths)
        got = layers._group_noise(qw, cfg, key, "col", ns, widths, None)
        wide = tuple(tdvmm.padded_size(t.shape[-1], tdvmm.LANE, tdvmm.LANE)
                     for t in ws)
        ref = quant.program_noise(quant.concat_group(
            [quant.program_weights(t, 6, True) for t in ws], wide),
            cfg.spec, key).codes
        off = lo = 0
        for i, (t, m) in enumerate(zip(ws, ns)):
            check(f"grouped{i}", got.codes[:, lo:lo + m],
                  ref[:, off + r * m:off + (r + 1) * m])
            off += wide[i]
            lo += widths[i]
    return {"bad": bad, "held": held}


# --------------------------------------------------------------------------
# The KV groups split (kimi-k2's attention at a model axis of 16)
# --------------------------------------------------------------------------
def _groups_train(cfg, params, batch: dict, shape, accum: int = 1,
                  opt: str = "adamw"):
    """A RunConfig, optimizer and whole state of ``params`` for steps of
    ``cfg`` on ``batch`` in ``accum`` microbatches a data rank."""
    from repro_torch.configs import OptimizerConfig, RunConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.optim import optimizer as om
    rows, seq = batch["inputs"].shape
    dp = shape[0] if shape is not None else 1
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "small", seq, rows, "train",
        microbatch_per_shard=rows // dp // accum),
        optimizer=OptimizerConfig(name=opt, lr=1e-3, warmup_steps=1,
                                  total_steps=3))
    opt_ = om.make_optimizer(run.optimizer)
    return run, opt_, steps.TrainState(params, opt_.init(params))


def kv_group_qat(np_params: dict, batch: dict, shape, kv: int, hd: int):
    """One QAT step (every linear a 6-bit TD-VMM site, the aux losses'
    coefficients 0: a data shard's are its own rows') of the smoke kimi-k2
    under the KV groups split on a mesh of ``shape``: the gradients the
    optimizer gets, gathered whole, the loss, and this rank's ``wk`` /
    ``wv`` shards after the update (parameters and moments), to hold the
    copies of a KV head equal."""
    import functools
    from repro_torch.launch import steps
    from repro_torch.optim import optimizer as om
    cfg = placement_cfg("kimi-k2-1t-a32b", kv, hd).replace(
        tdvmm=TDVMMLayerConfig(enabled=True, bits=6, weight_bits=6))
    run, opt, state = _groups_train(
        cfg, convert.params_from_numpy(np_params, cfg, "cpu"), batch, shape)
    got = []
    update, loss_fn = om.Optimizer.update, model.loss_fn

    def spy(self, grads, *a, **kw):
        got.append(grads)
        return update(self, grads, *a, **kw)
    om.Optimizer.update = spy
    model.loss_fn = functools.partial(loss_fn, lb_coef=0.0, z_coef=0.0)
    try:
        mesh = meshlib.make_test_mesh(*shape)
        specs = steps.state_specs(state, cfg, mesh)
        new, m = steps.make_train_step(cfg, run, opt, mesh=mesh,
                                       specs=specs)(
            steps.shard_state(state, cfg, mesh), batch)
    finally:
        om.Optimizer.update, model.loss_fn = update, loss_fn
    with meshctx.use_mesh_of(mesh):
        split = meshctx.attn_split(cfg, meshctx.tp_size())
    whole = sharding.gather_tree(got[0], specs[0].params, mesh)
    kv_leaves = {p: t.numpy() for p, t in leaves_with_paths(new)
                 if "/attn/wk/" in p or "/attn/wv/" in p}
    return {"split": split, "loss": float(m["loss"]),
            "grads": {p: g.numpy() for p, g in leaves_with_paths(whole)},
            "kv_leaves": kv_leaves}


def kv_group_checkpoint(directory: str, kv: int, hd: int, to: tuple):
    """A 2 x 2 state of the smoke kimi-k2 under the KV groups split,
    saved whole (gathered: each KV head once) and restored elastically on
    a mesh of ``to``: whole leaves and shards exact?"""
    from repro_torch.checkpoint import checkpoint as ckpt
    cfg = placement_cfg("kimi-k2-1t-a32b", kv, hd)
    params = model.init_params(5, cfg, device="cpu")
    mesh_a = meshlib.make_test_mesh(2, 2)
    spec_a = sharding.param_specs(params, cfg, mesh_a)
    shards_a = sharding.shard_tree(params, spec_a, mesh_a)
    whole = sharding.gather_tree(shards_a, spec_a, mesh_a)
    sub = os.path.join(directory, "x".join(map(str, to)))
    if rank() == 0:
        ckpt.save(whole, sub, step=3)
    dist.barrier()
    mesh_b = meshlib.make_test_mesh(*to)
    spec_b = sharding.param_specs(params, cfg, mesh_b)
    like = sharding.shard_tree(params, spec_b, mesh_b)
    restored, step = ckpt.restore(like, sub, shardings=(spec_b, mesh_b))
    back = sharding.gather_tree(restored, spec_b, mesh_b)
    groups = sum(getattr(a, "kind", None) == "groups"
                 for _, s in leaves_with_paths(spec_a) for a in s)
    return {"step": step, "groups_leaves": groups,
            "saved_exact": all(torch.equal(a, b) for (_, a), (_, b) in zip(
                leaves_with_paths(params), leaves_with_paths(whole))),
            "exact": all(torch.equal(a, b) for (_, a), (_, b) in zip(
                leaves_with_paths(params), leaves_with_paths(back))),
            "shards_exact": all(torch.equal(a, b) for (_, a), (_, b) in zip(
                leaves_with_paths(restored), leaves_with_paths(
                    sharding.shard_tree(params, spec_b, mesh_b))))}


def _old_accumulate(grads_of, params, batch: dict, accum: int):
    """The training step's accumulation before the in-place accumulator: a
    new float32 tree per microbatch, ``a + b.to(float32)``, then a new one
    for ``/ accum``."""
    from repro_torch.tree import leaves
    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in leaves(params)]
    msum = None
    for i in range(accum):
        mb = {k: v.reshape((accum, v.shape[0] // accum)
                           + tuple(v.shape[1:]))[i]
              for k, v in batch.items()}
        g, m = grads_of(params, mb)
        gsum = [a + b.to(torch.float32) for a, b in zip(gsum, g)]
        msum = m if msum is None else {k: msum[k] + m[k] for k in msum}
    grads = [g / accum for g in gsum]
    metrics = {k: v / accum for k, v in msum.items()}
    metrics["tokens"] = msum["tokens"]
    return grads, metrics


def accumulation_bitwise(arch: str, batch: dict, shape, accum: int,
                         kv: int = 0, hd: int = 0):
    """Two steps of ``accum`` microbatches (bfloat16 weights, so the
    accumulator's upcast matters), meshless (``shape`` None) or on a mesh
    of ``shape``, with the in-place accumulator and with the formula it
    replaced (``_old_accumulate``): the whole TrainStates and the metrics
    equal bit for bit?"""
    from repro_torch.launch import steps
    cfg = placement_cfg(arch, kv, hd).replace(dtype="bfloat16")
    run, opt, state = _groups_train(cfg, model.init_params(3, cfg, "cpu"),
                                    batch, shape, accum)
    mesh = specs = None
    if shape is not None:
        mesh = meshlib.make_test_mesh(*shape)
        specs = steps.state_specs(state, cfg, mesh)
    out = []
    new = steps.accumulate
    for fn in (new, _old_accumulate):
        steps.accumulate = fn
        try:
            step = steps.make_train_step(cfg, run, opt, accum, mesh=mesh,
                                         specs=specs)
            st = state if mesh is None else steps.shard_state(state, cfg,
                                                              mesh)
            metrics = []
            for _ in range(2):
                st, m = step(st, batch)
                metrics.append({k: float(v) for k, v in m.items()})
            if mesh is not None:
                st = steps.gather_state(st, specs[0], mesh)
            out.append((st, metrics))
        finally:
            steps.accumulate = new
    (a, ma), (b, mb) = out

    def bits(t):
        return t.reshape(-1).contiguous().view(torch.uint8)
    la, lb = leaves_with_paths(a), leaves_with_paths(b)
    return {"leaves": len(la),
            "bitwise": all(pa == pb and torch.equal(bits(x), bits(y))
                           for (pa, x), (pb, y) in zip(la, lb)),
            "metrics": ma == mb, "accum": accum}


def kv_group_noise(seed: int, kv: int = 2, hd: int = 14):
    """Programming noise on the grouped ``attn.qkv`` launch's shard under
    the KV groups split on 1 x 4 (4 heads, ``kv`` KV heads of ``hd``
    lanes): each member's noisy codes (``wq``'s chunk, ``wk`` / ``wv``'s
    KV head, ``layers._group_noise`` with the members' replicas) against
    the meshless concat bank's, sliced: the members that differ."""
    from repro_torch.kernels.tdvmm import tdvmm
    mesh = meshlib.make_test_mesh(1, 4)
    g = torch.Generator().manual_seed(seed)
    cfg = TDVMMLayerConfig(enabled=True, noise=True)
    k, key = 64, 21 + seed
    ws = [torch.randn((k, 4 * hd), generator=g)] + [
        torch.randn((k, kv * hd), generator=g) for _ in range(2)]
    wide = tuple(tdvmm.padded_size(t.shape[-1], tdvmm.LANE, tdvmm.LANE)
                 for t in ws)
    ref = quant.program_noise(quant.concat_group(
        [quant.program_weights(t, 6, True) for t in ws], wide),
        cfg.spec, key).codes
    with meshctx.use_mesh_of(mesh):
        tp, r = meshctx.tp_size(), meshctx.tp_rank()
        h = meshctx.kv_head(tp, kv, r)
        cols = torch.arange(h * hd, (h + 1) * hd)
        local = [ws[0].chunk(tp, -1)[r], ws[1][:, cols], ws[2][:, cols]]
        ns = (hd, hd, hd)
        widths = tuple(tdvmm.padded_size(n, tdvmm.LANE, tdvmm.LANE)
                       for n in ns)
        qw = quant.concat_group([quant.program_weights(t, 6, True)
                                 for t in local], widths)
        got = layers._group_noise(qw, cfg, key, "col", ns, widths,
                                  (None, cols, cols),
                                  (1, tp // kv, tp // kv)).codes
    starts = (r * hd, wide[0] + h * hd, wide[0] + wide[1] + h * hd)
    bad, lo = [], 0
    for i, (s0, wd) in enumerate(zip(starts, widths)):
        if not torch.equal(got[:, lo:lo + hd], ref[:, s0:s0 + hd]):
            bad.append(i)
        lo += wd
    return bad
