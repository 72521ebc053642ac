"""Training driver — torch port of ``repro.launch.train``: config -> state
-> fault-tolerant loop, on one device or on a (data, model) mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --smoke --tdvmm --steps 3 --batch 4 --seq 64 --device cpu

(``--smoke`` reduces the model, not the batch: ``--shape`` (default
``train_4k``, 256 x 4096 tokens) holds unless ``--batch``/``--seq`` say
otherwise, as in the JAX package.)

Without ``--device`` it runs on the card, and raises when there is none.
What it exercises, as the JAX package's driver does:
  * gradient-accumulation microbatching (float32 gradient sums);
  * the deterministic resumable data pipeline (``data/pipeline``);
  * atomic checkpoint/restore with auto-resume, keep-k and a non-blocking
    save (``checkpoint/checkpoint``);
  * the preemption guard (SIGTERM -> save + clean exit), step retry, the
    straggler monitor and the heartbeat (``runtime/fault``).
With ``--tdvmm`` every linear runs through the TD-VMM layer (QAT): on the
card each site's forward is kernel B2 (the data-calibrated readout), or B1
where a site has no readout, and the backward is the straight-through
custom gradient of ``kernels/tdvmm/ops``.

``--mesh DxT`` trains on a (data, model) mesh, one process per device
(``launch.steps``: FSDP + TP state, data-parallel gradient averaging;
``--grad-compression int8`` for the int8 error-feedback all-reduce).
Checkpoints hold the whole state, gathered, so a run may resume on another
mesh.  Every family trains under tensor parallelism, with ``--tdvmm`` too
(each shard takes the reference's custom gradient on its slices; noise is
drawn for the whole weight and sliced):

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke --tdvmm \
        --steps 3 --batch 4 --seq 64 --device cpu --mesh 2x2
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import (SHAPES, OptimizerConfig, RunConfig,
                                 get_config, smoke)
from repro_torch.data.pipeline import DataConfig, make_pipeline
import torch.distributed as dist

from repro_torch.launch import meshctx, steps
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import axis_info
from repro_torch.models import common
from repro_torch.optim.optimizer import make_optimizer
from repro_torch.runtime import fault


def build(run: RunConfig, accum: int | None = None, device=None, mesh=None):
    """Returns (train_step, state, accum) on ``device`` (the card unless
    given); on ``mesh`` the state is this rank's shards, and the step
    carries its placements as ``step.specs``."""
    device = common.resolve_device(device)
    optimizer = make_optimizer(run.optimizer)
    dp_size = 1
    if mesh is not None:
        dp_size = meshctx.axis_size(axis_info(mesh)["dp_axes"], mesh)
    if accum is None:
        accum = steps.grad_accum_steps(run, dp_size)
    state = steps.init_train_state(run.seed, run.model, optimizer, device)
    specs = None
    if mesh is not None:
        compress = run.optimizer.grad_compression == "int8"
        specs = steps.state_specs(state, run.model, mesh, compress)
        state = steps.shard_state(state, run.model, mesh, compress)
    step_fn = steps.make_train_step(run.model, run, optimizer, accum,
                                    mesh=mesh, specs=specs)
    step_fn.specs = specs
    return step_fn, state, accum


def train_loop(run: RunConfig, total_steps: int, accum: int | None = None,
               log_every: int = 10, device=None, mesh=None) -> dict:
    """Train to ``total_steps``, resuming from the latest checkpoint in
    ``run.checkpoint_dir``; returns the logged history (float metrics per
    logged step), whether a preemption stopped it, the step reached, the
    wall seconds and the straggler count.  On ``mesh`` every rank runs
    it; rank 0 writes the (gathered, whole) checkpoints."""
    cfg = run.model
    step_fn, state, accum = build(run, accum, device, mesh)
    pipe = make_pipeline(cfg, run.shape, DataConfig(seed=run.seed))
    specs = step_fn.specs

    def save(state, step, **kw):
        if mesh is None:
            return ckpt.save(state, run.checkpoint_dir, step, **kw)
        whole = steps.gather_state(state, specs[0], mesh)
        if dist.get_rank() == 0:
            ckpt.save(whole, run.checkpoint_dir, step,
                      **dict(kw, blocking=True))
        dist.barrier()

    # --- auto-resume -------------------------------------------------------
    start_step = 0
    if ckpt.latest_step(run.checkpoint_dir) is not None:
        state, start_step = ckpt.restore(
            state, run.checkpoint_dir,
            shardings=None if mesh is None else (specs[0], mesh))
        print(f"[resume] from step {start_step}")

    guard = fault.PreemptionGuard().install()
    monitor = fault.StragglerMonitor()
    hb = fault.Heartbeat(os.path.join(run.checkpoint_dir, "heartbeat.json"),
                         every_s=10)
    history = []
    t_start = time.time()
    step = start_step
    try:
        while step < total_steps:
            batch = pipe.batch_at(step)
            t0 = time.time()
            state, metrics = fault.retry_step(step_fn, state, batch)
            m = {k: float(v) for k, v in metrics.items()}  # waits for the step
            dt = time.time() - t0
            monitor.record(step, dt)
            hb.beat(step)
            if step % log_every == 0 or step == total_steps - 1:
                m.update(step=step, dt=round(dt, 3))
                history.append(m)
                print(f"[train] step={step} loss={m['loss']:.4f} "
                      f"gnorm={m['grad_norm']:.3f} dt={dt:.2f}s", flush=True)
            step += 1
            if guard.requested:
                print("[preempt] SIGTERM received — checkpointing and "
                      "exiting")
                save(state, step, keep=run.keep_checkpoints)
                return {"history": history, "preempted": True, "step": step}
            if step % run.checkpoint_every == 0:
                save(state, step, keep=run.keep_checkpoints, blocking=False)
        save(state, step, keep=run.keep_checkpoints)
    finally:
        guard.uninstall()
    return {
        "history": history,
        "preempted": False,
        "step": step,
        "total_s": time.time() - t_start,
        "stragglers": monitor.stragglers,
        "state": state,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable with a "
                         "small --batch and --seq)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--tdvmm", action="store_true",
                    help="run all linears through the TD-VMM layer (QAT)")
    ap.add_argument("--tdvmm-bits", type=int, default=6)
    ap.add_argument("--mesh", default=None, metavar="DxT",
                    help="train on a (data, model) mesh of D x T processes "
                         "(start them with python -m torch.distributed.run "
                         "--nproc-per-node D*T)")
    ap.add_argument("--grad-compression", default="none",
                    choices=("none", "int8"),
                    help="the data-parallel gradient all-reduce")
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain torch path; default: the card")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke(cfg)
    if args.tdvmm:
        from repro_torch.core.layers import TDVMMLayerConfig
        cfg = cfg.replace(tdvmm=TDVMMLayerConfig(
            enabled=True, bits=args.tdvmm_bits, weight_bits=args.tdvmm_bits))
    shape = SHAPES[args.shape]
    if args.batch or args.seq:
        shape = dataclasses.replace(
            shape,
            global_batch=args.batch or shape.global_batch,
            seq_len=args.seq or shape.seq_len)
    run = RunConfig(model=cfg, shape=shape,
                    optimizer=OptimizerConfig(
                        lr=args.lr, total_steps=args.steps,
                        grad_compression=args.grad_compression),
                    checkpoint_dir=args.ckpt_dir,
                    checkpoint_every=args.ckpt_every)
    mesh = None
    if args.mesh:
        _, _, device = mesh_lib.init_distributed(args.device)
        args.device = str(device)
        mesh = mesh_lib.parse_mesh(args.mesh, device.type)
    out = train_loop(run, args.steps, device=args.device, mesh=mesh)
    if out["history"]:
        print(f"[done] steps={out['step']} loss "
              f"{out['history'][0]['loss']:.3f} -> "
              f"{out['history'][-1]['loss']:.3f}")
    else:
        print(f"[done] steps={out['step']}: nothing left to train (resumed "
              f"at the last step from {args.ckpt_dir})")
    return out


if __name__ == "__main__":
    main()
