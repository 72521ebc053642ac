"""Train step factory — torch port of ``repro.launch.steps`` (the training
half; the serving steps are ``models/model``'s).

``make_train_step`` takes a gradient per microbatch and sums them in
float32 (the memory lever for large batches), then applies the optimizer.
A step is functional: it returns a new ``TrainState``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import model
from repro_torch.optim.optimizer import Optimizer, OptState
from repro_torch.tree import leaves, tree_map, unflatten


class TrainState(NamedTuple):
    params: Any
    opt: OptState


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


def make_train_step(cfg: ModelConfig, run: RunConfig, optimizer: Optimizer,
                    accum: int = 1, key=None):
    """``train_step(state, batch) -> (state, metrics)``; ``batch`` holds
    numpy or tensor ``inputs`` and ``targets`` of the global batch, split
    into ``accum`` microbatches along the batch axis.  ``key`` (an int
    seed) draws programming noise at sites that set ``noise``; the JAX
    package's train step passes none."""

    def grads_of(params, batch):
        ps = leaves(params)
        for p in ps:
            p.requires_grad_(True)
        total, metrics = model.loss_fn(params, batch, cfg, key)
        grads = torch.autograd.grad(total, ps)
        for p in ps:
            p.requires_grad_(False)
        return unflatten(params, list(grads)), {
            k: v.detach() for k, v in metrics.items()}

    def train_step(state: TrainState, batch: dict):
        params = state.params
        device = leaves(params)[0].device
        batch = _to_device(batch, device)
        if accum <= 1:
            grads, metrics = grads_of(params, batch)
        else:
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=device), params)
            msum = None
            for i in range(accum):
                mb = {k: v.reshape((accum, v.shape[0] // accum)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                g, m = grads_of(params, mb)
                gsum = tree_map(lambda a, b: a + b.to(torch.float32), gsum, g)
                msum = m if msum is None else {k: msum[k] + m[k] for k in msum}
            grads = tree_map(lambda g: g / accum, gsum)
            metrics = {k: v / accum for k, v in msum.items()}
            metrics["tokens"] = msum["tokens"]
        new_params, new_opt, opt_metrics = optimizer.update(grads, state.opt,
                                                            params)
        metrics.update(opt_metrics)
        metrics["step"] = state.opt.step
        return TrainState(new_params, new_opt), metrics

    return train_step
