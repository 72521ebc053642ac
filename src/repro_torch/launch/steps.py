"""Train, prefill and decode step factories — torch port of
``repro.launch.steps``.

``make_train_step`` takes a gradient per microbatch and sums them into
one float32 accumulator in place (the memory lever for large batches, as
the JAX step's scan carry), then applies the optimizer.  A step is
functional: it returns a new ``TrainState``; each whole-tree temporary
inside it (the gathered compute-layout parameters, a microbatch's
gradients, the data-axes reduction) is released or reused once read.

On a mesh (``mesh=``) the state holds this rank's shards under
``state_specs`` (``launch.sharding.param_specs`` / ``opt_state_specs``:
FSDP over the data axes, TP over ``model``, expert banks over the data
axes under ``moe.impl='ep'``).  A step all-gathers the FSDP dims into the
compute layout (``param_specs(..., dp_axes=())``), takes the gradient of
this rank's rows of the global batch (TP collectives inside the model),
averages the gradients over the data axes — with the int8 error-feedback
all-reduce under ``grad_compression="int8"``, whose residuals the state
carries — and applies the optimizer to its shards (the global norm and
Adafactor's factored means summed over the axes that split them).
Leaves replicated over ``model`` get their whole gradient on every
``model`` rank from the model's TP operators (``meshctx.copy_to_tp``); a
KV head that the ranks of its KV group each hold (the KV groups split)
gets only its rank's query heads' part there, and the step sums it over
the group (``meshctx.kv_group_sum``, in rank order: every copy stays
equal).
An expert bank split over the data axes (EP) is reduced by the
all-to-all's backward already: its owner holds the sum of every data
rank's gradient, and divides it by their count.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.launch import meshctx, sharding
from repro_torch.models import model
from repro_torch.optim.compression import compressed_all_reduce
from repro_torch.optim.optimizer import Optimizer, OptState
from repro_torch.tree import leaves, leaves_with_paths, tree_map, unflatten


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    # on a mesh under grad_compression="int8": this data rank's error
    # feedback, one float32 leaf (1, *compute shard) per parameter the data
    # axes reduce (None for an expert bank they split), saved with the state
    residuals: Any = None


def init_train_state(seed: int, cfg: ModelConfig, optimizer: Optimizer,
                     device=None) -> TrainState:
    params = model.init_params(seed, cfg, device=device)
    return TrainState(params=params, opt=optimizer.init(params))


def grad_accum_steps(run: RunConfig, dp_size: int) -> int:
    """How many microbatches per step."""
    shape = run.shape
    if shape.kind != "train":
        return 1
    per_shard = max(shape.global_batch // max(dp_size, 1), 1)
    mb = shape.microbatch_per_shard or _auto_microbatch(run.model,
                                                        shape.seq_len)
    mb = min(mb, per_shard)
    return max(per_shard // mb, 1)


def _auto_microbatch(cfg: ModelConfig, seq_len: int) -> int:
    """Target ~8k tokens per shard per microbatch."""
    return max(8192 // seq_len, 1)


def _to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def state_specs(state: TrainState, cfg: ModelConfig, mesh,
                compress: bool = False):
    """(the state's placements, the params' compute placements) on
    ``mesh``: FSDP + TP (+ EP) for the state, TP (+ EP) for the step.
    ``compress`` (``grad_compression="int8"``): the residuals' placements
    too, each its parameter's compute placement under a leading dim over
    the data axes (one row per data rank: a checkpoint holds them all, and
    restores onto a mesh of the same data size only)."""
    from repro_torch.launch.mesh import axis_info
    dp = axis_info(mesh)["dp_axes"]
    p_specs = sharding.param_specs(state.params, cfg, mesh)
    o_specs = sharding.opt_state_specs(state.opt, p_specs)
    compute = sharding.param_specs(state.params, cfg, mesh, dp_axes=(),
                                   ep_axes=dp)
    r_specs = None
    if compress:
        r_specs = tree_map(lambda sp: None if _data_split(sp, dp)
                           else sharding.P(dp, *sp), compute)
    return TrainState(p_specs, o_specs, r_specs), compute


def _data_split(spec, dp_axes) -> bool:
    """Whether a placement splits a dim over the data axes."""
    return any(a in dp_axes for ax in spec if ax is not None
               for a in (ax if isinstance(ax, tuple) else (ax,)))


def shard_state(state: TrainState, cfg: ModelConfig, mesh,
                compress: bool = False) -> TrainState:
    """This rank's shards of a whole training state (with zero residuals
    under ``compress``)."""
    specs, _ = state_specs(state, cfg, mesh, compress)
    residuals = None
    if compress:
        residuals = tree_map(
            lambda p, sp: None if sp is None else torch.zeros(
                (1,) + sharding.local_shape(tuple(p.shape),
                                            sharding.P(*list(sp)[1:]), mesh),
                dtype=torch.float32, device=p.device),
            state.params, specs.residuals)
    return TrainState(sharding.shard_tree(state.params, specs.params, mesh),
                      sharding.shard_tree(state.opt, specs.opt, mesh),
                      residuals)


def gather_state(state: TrainState, specs: TrainState, mesh) -> TrainState:
    """The whole training state from every rank's shards.  Collective."""
    residuals = None
    if state.residuals is not None:
        residuals = sharding.gather_tree(state.residuals, specs.residuals,
                                         mesh)
    return TrainState(sharding.gather_tree(state.params, specs.params, mesh),
                      sharding.gather_tree(state.opt, specs.opt, mesh),
                      residuals)


def _kv_group_sum(grads, compute):
    """Each replicated KV head's gradient (a ``wk`` / ``wv`` leaf under the
    KV groups split) summed over its KV group, in float32."""
    specs = dict(leaves_with_paths(compute))
    out = []
    for path, g in leaves_with_paths(grads):
        ax = sharding.groups_entry(specs[path])
        if ax is not None:
            g = meshctx.kv_group_sum(g.to(torch.float32),
                                     ax.copies(meshctx.tp_size()))
        out.append(g)
    return unflatten(grads, out)


def _data_mean(grads, compute, residuals, compress: bool):
    """Each leaf's gradient of the global batch's mean loss from this data
    rank's: the mean over the data axes (the int8 error-feedback all-reduce
    under ``compress``, which returns the new residuals), or for an expert
    bank the data axes split, its sum over them (already here) / their
    count.  In place on a float32 gradient (no second tree).  Returns
    (gradients, residuals)."""
    dp, n = meshctx.dp_axes(), float(meshctx.dp_size())
    specs = dict(leaves_with_paths(compute))
    have = dict(leaves_with_paths(residuals))
    out, new = [], {}
    for path, g in leaves_with_paths(grads):
        g = g.to(torch.float32)
        if _data_split(specs[path], dp):
            out.append(g.div_(n))
        elif compress:
            y, r = compressed_all_reduce(g, meshctx.dp_group(),
                                         have[path][0])
            out.append(y)
            new[path] = r[None]
        else:
            dist.all_reduce(g, group=meshctx.dp_group())
            out.append(g.div_(n))
    if compress:
        residuals = unflatten(residuals, [new[p] for p, _ in
                                          leaves_with_paths(residuals)])
    return unflatten(grads, out), residuals


def accumulate(grads_of, params, batch: dict, accum: int):
    """The mean gradient of ``accum`` microbatches of ``batch`` (split
    along the batch axis) and their mean metrics (``tokens`` summed):
    ``grads_of(params, microbatch)`` -> (gradients as a list in
    ``leaves(params)`` order, metrics).  One float32 accumulator, each
    microbatch's gradients added into it in place and released once read:
    the values of ``a + b.to(float32)`` per microbatch, then / accum."""
    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in leaves(params)]
    msum = None
    for i in range(accum):
        mb = {k: v.reshape((accum, v.shape[0] // accum)
                           + tuple(v.shape[1:]))[i]
              for k, v in batch.items()}
        g, m = grads_of(params, mb)
        for j, a in enumerate(gsum):
            a.add_(g[j])
            g[j] = None
        del g
        msum = m if msum is None else {k: msum[k] + m[k] for k in msum}
    for a in gsum:
        a.div_(accum)
    metrics = {k: v / accum for k, v in msum.items()}
    metrics["tokens"] = msum["tokens"]
    return gsum, metrics


def make_train_step(cfg: ModelConfig, run: RunConfig, optimizer: Optimizer,
                    accum: int = 1, key=None, mesh=None, specs=None):
    """``train_step(state, batch) -> (state, metrics)``; ``batch`` holds
    numpy or tensor ``inputs`` and ``targets`` of the global batch, split
    into ``accum`` microbatches along the batch axis (per data shard on a
    mesh).  ``key`` (an int seed) draws programming noise at sites that set
    ``noise``; the JAX package's train step passes none.  On ``mesh`` the
    state is sharded; ``specs`` = ``state_specs(...)`` of it (under
    ``grad_compression="int8"`` the state from ``shard_state(...,
    compress=True)``, which carries the residuals)."""
    compress = mesh is not None and \
        optimizer.cfg.grad_compression == "int8"

    def grads_of(params, batch):
        """(the gradients as a list in ``leaves(params)`` order, metrics)."""
        ps = leaves(params)
        for p in ps:
            p.requires_grad_(True)
        total, metrics = model.loss_fn(params, batch, cfg, key)
        grads = list(torch.autograd.grad(total, ps))
        for p in ps:
            p.requires_grad_(False)
        return grads, {k: v.detach() for k, v in metrics.items()}

    def local_step(params, batch):
        batch = _to_device(batch, leaves(params)[0].device)
        if accum <= 1:
            grads, metrics = grads_of(params, batch)
        else:
            grads, metrics = accumulate(grads_of, params, batch, accum)
        return unflatten(params, grads), metrics

    def train_step(state: TrainState, batch: dict):
        if mesh is None:
            grads, metrics = local_step(state.params, batch)
            new_params, new_opt, opt_metrics = optimizer.update(
                grads, state.opt, state.params)
            residuals = None
        else:
            with meshctx.use_mesh_of(mesh):
                new_params, new_opt, residuals, metrics, opt_metrics = \
                    mesh_step(state, batch)
        metrics.update(opt_metrics)
        metrics["step"] = state.opt.step
        return TrainState(new_params, new_opt, residuals), metrics

    def mesh_step(state: TrainState, batch: dict):
        st_specs, compute = specs
        if compress and state.residuals is None:
            raise ValueError("grad_compression='int8' on a mesh needs the "
                             "residuals in the state: shard_state(..., "
                             "compress=True)")
        params = sharding.regather(state.params, st_specs.params, compute,
                                   mesh)
        rows = len(batch["inputs"])
        b_specs = sharding.batch_specs(cfg, mesh, "train", rows)
        local = {k: sharding.shard(torch.as_tensor(v), b_specs[k], mesh)
                 for k, v in batch.items()}
        split = local["inputs"].shape[0] != rows
        with meshctx.split_rows(split):
            grads, metrics = local_step(params, local)
        del params, local                 # the gathered copies: read
        residuals = state.residuals
        grads = _kv_group_sum(grads, compute)
        if meshctx.dp_active():
            grads, residuals = _data_mean(grads, compute, residuals, compress)
            metrics = {k: (meshctx.dp_sum(v) if k == "tokens" else
                           meshctx.dp_mean(v)) for k, v in metrics.items()}
        grads = sharding.reshard(grads, compute, st_specs.params, mesh)
        new_params, new_opt, opt_metrics = optimizer.update(
            grads, state.opt, state.params, specs=st_specs.params)
        return new_params, new_opt, residuals, metrics, opt_metrics

    return train_step


def _serving_step(fn, cfg: ModelConfig, mesh, calib):
    def step(params, batch: dict, caches: dict):
        """(logits of this rank's rows, caches): ``batch["inputs"]`` is the
        global batch; on a mesh each rank runs its rows (a batch the data
        axes do not divide: all of them, against sequence-split caches,
        ``meshctx.split_seq``), ``params`` and ``caches`` its shards."""
        inputs = batch["inputs"]
        with meshctx.use_mesh_of(mesh):
            local = meshctx.dp_shard(inputs)
            split = local.shape[0] != inputs.shape[0]
            with meshctx.split_rows(split), meshctx.split_seq(not split):
                return fn(params, {"inputs": local}, caches, cfg,
                          calib=calib)
    return step


def make_prefill_step(cfg: ModelConfig, mesh=None, calib=None):
    """``prefill(params, batch, caches) -> (logits, caches)``:
    ``model.prefill_step`` on ``mesh`` (None: meshless); ``calib`` pins
    the TD-VMM readout windows.  Caches for it: ``init_serving_caches``."""
    return _serving_step(model.prefill_step, cfg, mesh, calib)


def make_decode_step(cfg: ModelConfig, mesh=None, calib=None):
    """``decode(params, batch, caches) -> (logits, caches)``:
    ``model.decode_step`` on ``mesh``, as ``make_prefill_step``."""
    return _serving_step(model.decode_step, cfg, mesh, calib)


def init_serving_caches(cfg: ModelConfig, global_batch: int, max_len: int,
                        device, mesh=None) -> dict:
    """This rank's caches for the serving steps on ``mesh``: its rows, KV
    heads (or lanes) and SSM heads; sequence-split when the data axes do
    not divide ``global_batch``, with ``max_len`` rounded up to a multiple
    of the data ranks (the tail positions are never written or
    attended)."""
    with meshctx.use_mesh_of(mesh):
        n = meshctx.dp_size()
        if global_batch % n == 0:
            return model.init_caches(cfg, global_batch // n, max_len, device)
        with meshctx.split_seq():
            return model.init_caches(cfg, global_batch, -(-max_len // n) * n,
                                     device)
