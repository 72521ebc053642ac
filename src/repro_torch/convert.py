"""Parameter conversion from the JAX package's layout to the port's.

``params_from_numpy`` takes the pytree ``repro.models.model.init_params``
returns, already turned into numpy arrays by the caller (for example with
``jax.tree.map(np.asarray, params)``), so this module never sees JAX.  The
JAX package stacks each segment's layers along a leading axis
(``params["blocks"]["seg0"]`` leaves are ``(L, ...)``); the port keeps a
list of per-layer dicts; every other entry of ``params["blocks"]`` (the
hybrid family's shared block ``shared_attn`` and its ``fuse`` projection)
converts as it is.  Every leaf takes the model's dtype except the SSM
scan parameters (``dt_bias``, ``A_log``, ``D``) and the MoE router
(``router``), which the JAX package keeps in float32 whatever the model's
dtype.  MoE expert banks (``w_gate``, ``w_up``, ``w_down``, each (E, ...))
and shared experts convert leaf by leaf like any other weight.

The circuit simulator (``core/tdcore``) needs no conversion: its parameters
are plain (N_in, N_out) weight matrices, handed to it as tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, transformer


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    # via float32: numpy has no native bfloat16, and widening is exact
    arr = np.array(a, np.float32)
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def leaf_from_numpy(a, device) -> torch.Tensor:
    """One JAX package leaf, given as a numpy array, as a tensor of its own
    dtype on ``device`` (numpy's bfloat16 extension type as
    ``torch.bfloat16``)."""
    name = np.asarray(a).dtype.name
    dtype = torch.bfloat16 if name == "bfloat16" else getattr(torch, name)
    return _tensor(a, dtype, device)


# leaves (and subtrees) the JAX package initialises in float32 for every
# model dtype
FLOAT32_LEAVES = frozenset({"dt_bias", "A_log", "D", "router"})


def _map(tree, fn, name: str = ""):
    """``fn(leaf, name)`` over a dict tree; a leaf inside a FLOAT32_LEAVES
    subtree gets that subtree's name."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, name if name in FLOAT32_LEAVES else k)
                for k, v in tree.items()}
    return fn(tree, name)


def _unstack(tree, n: int) -> list[dict]:
    return [_map(tree, lambda a, _, i=i: a[i]) for i in range(n)]


def params_from_numpy(tree: dict, cfg: ModelConfig, device) -> dict:
    """The port's parameter dict for ``cfg`` from the JAX package's
    parameter pytree as numpy arrays, on ``device`` in ``cfg.dtype``."""
    dtype = common.resolve_dtype(cfg.dtype)

    def conv(a, name):
        return _tensor(a, torch.float32 if name in FLOAT32_LEAVES else dtype,
                       device)

    out = {k: _map(v, conv) for k, v in tree.items() if k != "blocks"}
    segs = {f"seg{i}": n
            for i, (_, n) in enumerate(transformer.segments(cfg))}
    out["blocks"] = {
        k: ([_map(layer, conv) for layer in _unstack(v, segs[k])]
            if k in segs else _map(v, conv))
        for k, v in tree["blocks"].items()}
    missing = set(segs) - set(out["blocks"])
    if missing:
        raise ValueError(f"the parameter tree has no {sorted(missing)}")
    return out
