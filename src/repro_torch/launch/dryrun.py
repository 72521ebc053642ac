"""Production-mesh dry run without GPUs — the port's counterpart of
``repro.launch.dryrun``:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \\
        --shape prefill_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --both-meshes

For every (architecture x input shape x mesh) cell one rank (``--rank``)
of the JAX package's production mesh (16 x 16 over ("data", "model"), or
2 x 16 x 16 with ``--multi-pod``) runs the real train / prefill / decode
step under torch's fake process group (a world of 256 or 512 ranks, no
communication) inside ``FakeTensorMode``: every tensor has its shape and
dtype and no storage, so no card and no memory is needed.  The fake
tensors sit on the CPU device (Python indexing of a fake CUDA tensor
needs a torch built with CUDA) and take the card's route at every device
branch of the port (``kernels.hooks.card_route``).  Parameters, optimizer state (``optimizer_for``: Adafactor
with bf16 moments above 4e11 parameters), the batch and the caches are
fake tensors at this rank's shapes (``launch.sharding``'s placements;
serving keeps the weights replicated over the data axes, as
``serve_static`` does).  The kernel wrappers return their outputs'
shapes without launching (``kernels.hooks``).

``launch.roofline.StepCounter`` counts the step: FLOPs by operand class,
HBM bytes, collective wire bytes by kind and by link, kernel launches and
the peak of the bytes it allocates; with the arguments' bytes that peak
says whether the rank fits on an 80 GB card.  Each cell writes
``artifacts/dryrun_torch/<arch>__<shape>__pod1|pod2.json`` with the JAX
package's keys and statuses (``long_500k`` is skipped for the archs that
are not sub-quadratic, with its reason text) and the H100 roofline terms.
These are static estimates from data-sheet peaks, not measurements.

``--opt-level`` maps the JAX package's perf ladder onto the port: 1 casts
the TP partial products to bf16 before their all-reduce
(``common.set_tp_explicit``; its other half, explicit ``shard_map``
reductions and the matmuls' output dtype, are identities here: the
port's TP reductions are always explicit), 2 iterates only the causal /
in-window flash tiles (``attention.FLASH_BLOCK_SKIP``), 3 sets the MoE
capacity factor to 1.0.  ``--layers`` cuts every arch to that many layers
(whole hybrid groups), a knob for quick checks.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import (ARCHS, SHAPES, OptimizerConfig, RunConfig,
                                 get_config)
from repro_torch.core import constants as C
from repro_torch.launch import meshctx, roofline, sharding, steps
from repro_torch.launch.mesh import axis_info, make_production_mesh
from repro_torch.models import attention, common, model
from repro_torch.tree import leaves, tree_map

SKIP_REASON = ("pure full-attention arch; 524k dense KV cache is out of "
               "scope per DESIGN.md §5")


def optimizer_for(cfg) -> OptimizerConfig:
    """Adafactor + bf16 moments for ~T-param models."""
    if cfg.param_count() > 4e11:
        return OptimizerConfig(name="adafactor", moment_dtype="bfloat16")
    return OptimizerConfig()


def apply_opt_level(cfg, level: int):
    """The perf ladder's rungs on the port (see the module docstring)."""
    common.set_tp_explicit(level >= 1)
    attention.FLASH_BLOCK_SKIP = level >= 2
    if level >= 3 and cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=1.0))
    return cfg


def cut_depth(cfg, layers: int):
    """``cfg`` with at most ``layers`` layers (a hybrid keeps whole groups
    of ``hybrid_attn_every``; an MoE its dense lead-in at most)."""
    n = min(layers, cfg.n_layers)
    if cfg.hybrid_attn_every:
        n = max(n // cfg.hybrid_attn_every, 1) * cfg.hybrid_attn_every
    out = cfg.replace(n_layers=n)
    if cfg.moe is not None and cfg.moe.first_k_dense >= n:
        out = out.replace(moe=dataclasses.replace(
            cfg.moe, first_k_dense=max(n - 1, 0)))
    return out


def fake_world(world: int, rank: int) -> None:
    """Join torch's fake process group as ``rank`` of ``world`` (any world
    joined before is left first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_rank() == rank:
            return
        dist.destroy_process_group()
        meshctx._GROUPS.clear()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def _on(tree, device):
    """``tree`` on ``device``: fresh fake tensors for fake ones (their
    values are nothing to copy)."""
    from torch._subclasses.fake_tensor import is_fake

    def one(t):
        if not isinstance(t, torch.Tensor):
            return t
        if is_fake(t):
            return torch.empty(t.shape, dtype=t.dtype, device=device)
        return t.to(device)
    return tree_map(one, tree)


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def input_specs(cfg, shape, device) -> dict:
    """Every model input of a step of ``shape`` as zeros on ``device`` (fake
    tensors under the dry run's ``FakeTensorMode``: shapes and dtypes, no
    storage): the tokens or embeddings, and a training step's targets."""
    b, s = shape.global_batch, shape.seq_len
    s_in = 1 if shape.kind == "decode" else s
    if cfg.input_mode == "tokens":
        inputs = torch.zeros((b, s_in), dtype=torch.int32, device=device)
    else:
        inputs = torch.zeros((b, s_in, cfg.d_model), dtype=torch.bfloat16,
                             device=device)
    batch = {"inputs": inputs}
    if shape.kind == "train":
        batch["targets"] = torch.zeros((b, s), dtype=torch.int32,
                                       device=device)
    return batch


def _serving_params(cfg, mesh, device):
    """This rank's parameters for serving: drawn whole (fake: no storage)
    and sliced by the serving placements (replicated over the data axes
    but the expert banks, as ``serve_static`` places them)."""
    params = model.init_params(0, cfg, device="cpu")
    specs = sharding.param_specs(params, cfg, mesh, dp_axes=(),
                                 ep_axes=axis_info(mesh)["dp_axes"])
    return _on(sharding.shard_tree(params, specs, mesh), device)


def run_cell(cfg, shape, mesh, microbatch=None, device="cpu") -> dict:
    """One rank's step of ``shape`` on ``mesh`` (installed), counted:
    inside ``FakeTensorMode`` (the dry run), or on real tensors in a real
    world (the same count of a step that runs)."""
    info = axis_info(mesh)
    t0 = time.time()
    batch = input_specs(cfg, shape, device)
    if shape.kind == "train":
        opt_cfg = optimizer_for(cfg)
        run = RunConfig(model=cfg, shape=shape, optimizer=opt_cfg)
        from repro_torch.optim.optimizer import make_optimizer
        optimizer = make_optimizer(opt_cfg)
        dp = meshctx.axis_size(info["dp_axes"], mesh)
        accum = microbatch if microbatch is not None else \
            steps.grad_accum_steps(run, dp)
        whole = model.init_params(0, cfg, device="cpu")
        state = steps.TrainState(whole, optimizer.init(whole))
        specs = steps.state_specs(state, cfg, mesh)
        state = _on(steps.shard_state(state, cfg, mesh), device)
        del whole
        step = steps.make_train_step(cfg, run, optimizer, accum, mesh=mesh,
                                     specs=specs)
        args = (state, batch)
        arg_bytes = _bytes(state) + _bytes(
            {k: meshctx.dp_shard(v) for k, v in batch.items()})
        extra = {"accum": accum, "optimizer": opt_cfg.name,
                 "param_bytes": _bytes(state.params)}
    else:
        dp = info["dp_axes"]
        params = _serving_params(cfg, mesh, device)
        caches = steps.init_serving_caches(cfg, shape.global_batch,
                                           shape.seq_len, device, mesh)
        make = (steps.make_prefill_step if shape.kind == "prefill"
                else steps.make_decode_step)
        step = make(cfg, mesh)
        args = (params, batch, caches)
        with meshctx.use_mesh_of(mesh):
            rows = meshctx.dp_shard(batch["inputs"])
        arg_bytes = _bytes(params) + _bytes(caches) + _bytes(rows)
        extra = {"param_bytes": _bytes(params),
                 "cache_bytes": _bytes(caches),
                 "sequence_split": rows.shape[0] == shape.global_batch
                 and meshctx.axis_size(dp, mesh) > 1}
    t_setup = time.time() - t0
    counter = roofline.StepCounter()
    counter.known(*args)
    t0 = time.time()
    with counter, torch.no_grad() if shape.kind != "train" else \
            contextlib.nullcontext():
        out = step(*args)
    t_run = time.time() - t0
    out_bytes = _bytes(out)
    alias = _bytes(args[-1]) if shape.kind != "train" else 0
    peak = arg_bytes + counter.peak_bytes
    return {"setup_s": t_setup, "run_s": t_run, "arg_bytes": arg_bytes,
            "out_bytes": out_bytes, "alias_bytes": alias, "peak": peak,
            "counter": counter.summary(), "peak_by_op": counter.peak_by_op,
            **extra}


def count_fake(cfg, shape, mesh_shape: tuple, rank: int = 0,
               microbatch=None) -> dict:
    """``run_cell`` of ``cfg`` on a (data, model) mesh of ``mesh_shape``
    as rank ``rank`` of a fake world of that size (a check of the dry run
    against the same step counted in a real world)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import AXES_2D, make_mesh
    n = 1
    for d in mesh_shape:
        n *= d
    fake_world(n, rank)
    mesh = make_mesh(tuple(mesh_shape), AXES_2D, "cpu")
    with FakeTensorMode(allow_non_fake_inputs=True), \
            meshctx.use_mesh_of(mesh):
        return run_cell(cfg, shape, mesh, microbatch)


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               microbatch=None, opt_level: int = 0, tdvmm: bool = False,
               tdvmm_chained: bool = False, rank: int = 0,
               layers=None) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_config(arch)
    if tdvmm:
        from repro_torch.configs import TDVMMLayerConfig
        cfg = cfg.replace(tdvmm=TDVMMLayerConfig(
            enabled=True, bits=6, weight_bits=6,
            io_quantize=not tdvmm_chained))
    shape = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return {"status": "skipped", "reason": SKIP_REASON}
    if layers is not None:
        cfg = cut_depth(cfg, layers)
    old = (common.TP_EXPLICIT, attention.FLASH_BLOCK_SKIP)
    cfg = apply_opt_level(cfg, opt_level)
    fake_world(512 if multi_pod else 256, rank)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    try:
        with FakeTensorMode(allow_non_fake_inputs=True), \
                meshctx.use_mesh_of(mesh):
            r = run_cell(cfg, shape, mesh, microbatch)
    finally:
        common.set_tp_explicit(old[0])
        attention.FLASH_BLOCK_SKIP = old[1]
    c = r["counter"]
    chips = mesh.size()
    terms = roofline.RooflineTerms(
        chips=chips, flops_per_device=c["flops"],
        bytes_per_device=c["hbm_bytes"],
        coll_bytes_per_device=c["collective_bytes"]["total"],
        model_flops=roofline.model_flops(get_config(arch), shape),
        flops_by_class=c["flops_by_class"],
        coll_bytes_by_link=c["collective_bytes_by_link"])
    full = get_config(arch)
    return {
        "status": "ok",
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": list(mesh.mesh.shape),
        "mesh_axes": list(mesh.mesh_dim_names),
        "chips": chips,
        "rank": rank,
        "layers": cfg.n_layers,
        "lower_s": round(r["setup_s"], 1),
        "compile_s": round(r["run_s"], 1),
        "params": full.param_count(),
        "active_params": full.active_param_count(),
        "memory_analysis": {
            "generated_code_size_in_bytes": None,
            "argument_size_in_bytes": r["arg_bytes"],
            "output_size_in_bytes": r["out_bytes"],
            "temp_size_in_bytes": r["peak"] - r["arg_bytes"],
            "alias_size_in_bytes": r["alias_bytes"]},
        "peak_bytes": r["peak"],
        "fits_h100": r["peak"] <= C.H100_HBM_BYTES,
        "cost_analysis_raw": {"flops": c["flops"],
                              "bytes accessed": c["hbm_bytes"]},
        "flops_by_class": c["flops_by_class"],
        "collective_bytes": c["collective_bytes"],
        "collective_bytes_by_link": c["collective_bytes_by_link"],
        "kernel_launches": c["kernel_launches"],
        "step": {k: v for k, v in r.items()
                 if k in ("accum", "optimizer", "param_bytes",
                          "cache_bytes", "sequence_split")},
        # what the step holds at its peak beyond its arguments, by the op
        # and dtype that made it (``StepCounter.peak_by_op``, top 12)
        "temp_at_peak_by_op": dict(list(r["peak_by_op"].items())[:12]),
        "roofline": terms.as_dict(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--opt-level", type=int, default=0,
                    help="perf ladder (see the module docstring)")
    ap.add_argument("--tdvmm", action="store_true",
                    help="every linear a 6-bit TD-VMM site")
    ap.add_argument("--tdvmm-chained", action="store_true",
                    help="no readout between chained tiles")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV caches")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the mesh to count")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every arch to this many layers")
    args = ap.parse_args(argv)
    attention.set_kv_cache_int8(args.kv_int8)
    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    failures = 0
    try:
        for multi_pod in meshes:
            for arch in archs:
                for shape in shapes:
                    tag = f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}"
                    path = outdir / f"{tag}.json"
                    if path.exists() and not args.force:
                        print(f"[skip cached] {tag}")
                        continue
                    print(f"[dryrun] {tag} ...", flush=True)
                    t0 = time.time()
                    try:
                        result = lower_cell(
                            arch, shape, multi_pod, args.microbatch,
                            opt_level=args.opt_level, tdvmm=args.tdvmm,
                            tdvmm_chained=args.tdvmm_chained, rank=args.rank,
                            layers=args.layers)
                    except Exception as e:  # noqa: BLE001 — record, go on
                        result = {"status": "error", "arch": arch,
                                  "shape": shape, "multi_pod": multi_pod,
                                  "error": str(e),
                                  "traceback": traceback.format_exc()}
                        failures += 1
                    result["wall_s"] = round(time.time() - t0, 1)
                    path.write_text(json.dumps(result, indent=2))
                    status = result["status"]
                    extra = ""
                    if status == "ok":
                        r = result["roofline"]
                        extra = (f" dominant={r['dominant']}"
                                 f" t=({r['t_compute_s']:.3e},"
                                 f"{r['t_memory_s']:.3e},"
                                 f"{r['t_collective_s']:.3e})s peak="
                                 f"{result['peak_bytes'] / 1e9:.1f}GB"
                                 f" fits={result['fits_h100']}")
                    elif status == "error":
                        extra = " " + result["error"][:200]
                    print(f"[{status}] {tag}{extra}  "
                          f"({time.time() - t0:.0f}s)", flush=True)
    finally:
        attention.set_kv_cache_int8(False)
        if dist.is_initialized():
            dist.destroy_process_group()
            meshctx._GROUPS.clear()
    print(f"done, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
