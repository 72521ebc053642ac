"""Pipeline parallelism over the ``pod`` axis (GPipe-style inference
pipeline) — torch port of ``repro.launch.pipeline``.

The paper's section 3.1 chains VMM stages so that phase II of stage l is
phase I of stage l+1, with a new sample admitted every period (Fig. 2d).
At pod scale the same schedule maps onto the ``pod`` mesh axis: each pod
owns a contiguous slice of the layer stack; microbatches stream through,
and the stage boundary is one point-to-point hop per microbatch
(``batch_isend_irecv`` to the rank at the same (data, model) place of the
next pod).

Inside a stage the layers run tensor-parallel over ``model`` (this rank's
shards of them) on this rank's rows of the microbatch over ``data``, as the
model's own mesh paths do.  The GPipe schedule runs ``n_micro + n_stages -
1`` ticks; the last stage broadcasts its outputs over ``pod``, so every
rank holds them and the head runs replicated.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import meshctx, sharding
from repro_torch.models import common, model, transformer


def stage_layers(layers: list, n_stages: int, stage: int) -> list:
    """The contiguous slice of a homogeneous layer list one stage owns."""
    if len(layers) % n_stages:
        raise ValueError(f"{len(layers)} layers over {n_stages} stages")
    per = len(layers) // n_stages
    return layers[stage * per:(stage + 1) * per]


def _peer(mesh, pod: int) -> int:
    """The global rank at this rank's (data, model) place in ``pod``."""
    names = list(mesh.mesh_dim_names)
    idx = [mesh.get_local_rank(a) for a in names]
    idx[names.index("pod")] = pod
    return int(mesh.mesh[tuple(idx)])


@torch.no_grad()
def pp_forward(params, batch_tokens: torch.Tensor, cfg: ModelConfig, mesh,
               n_micro: int = 8) -> torch.Tensor:
    """Pipelined forward (logits (B, S, V)) for a homogeneous dense stack.

    params: the whole model's params (``model.init_params`` layout, one
    segment); every rank of a ``("pod", "data", "model")`` mesh calls this
    with the same params and ``batch_tokens`` (B, S), B % n_micro == 0.
    Collective."""
    segs = transformer.segments(cfg)
    if len(segs) != 1 or segs[0][0] != "attn_ffn":
        raise ValueError("pp_forward pipelines a homogeneous attention "
                         f"stack, not {segs}")
    n_stages = meshctx.axis_size("pod", mesh)
    stage = meshctx.axis_rank("pod", mesh)
    mine = {"seg0": stage_layers(params["blocks"]["seg0"], n_stages, stage)}
    specs = sharding.param_specs(mine, cfg, mesh, dp_axes=())
    mine = sharding.shard_tree(mine, specs, mesh)["seg0"]

    # embed outside the pipeline (replicated over pod)
    x = params["embed"]["table"][batch_tokens.long()]
    b, s, d = x.shape
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         "microbatches")
    x_mb = x.reshape(n_micro, b // n_micro, s, d)
    last = n_stages - 1
    with meshctx.use_mesh(mesh, ("data",), "model"):
        lcfg = meshctx.local_config(cfg)
        mb = common.constrain_batch(x_mb[0]).shape[0]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(mb, s)

        def body(h):
            for lp in mine:
                h, _, _ = transformer.attn_ffn_train(lp, h, lcfg, positions)
            return h

        buf = torch.zeros((mb, s, d), dtype=x.dtype, device=x.device)
        outs = []
        for t in range(n_micro + n_stages - 1):
            if stage == 0 and t < n_micro:
                buf = common.constrain_batch(x_mb[t])
            out = body(buf)
            ops = []
            if stage < last:
                ops.append(dist.P2POp(dist.isend, out.contiguous(),
                                      _peer(mesh, stage + 1)))
            recv = None
            if stage > 0:
                recv = torch.empty_like(out)
                ops.append(dist.P2POp(dist.irecv, recv,
                                      _peer(mesh, stage - 1)))
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            if recv is not None:
                buf = recv
            # microbatch m leaves the last stage at tick m + n_stages - 1
            if t >= last:
                outs.append(out if stage == last else torch.zeros_like(out))
        outs = torch.stack(outs)                    # (n_micro, mb, s, d)
        # broadcast the last stage's outputs so the head is replicated
        dist.broadcast(outs, src=_peer(mesh, last),
                       group=meshctx.axes_group("pod", mesh))
        outs = meshctx.dp_gather(outs.transpose(0, 1), b // n_micro)
    h = outs.transpose(0, 1).reshape(b, s, d)
    h = common.rmsnorm(params["ln_f"], h, cfg.norm_eps)
    return model._head(params, h, cfg)
