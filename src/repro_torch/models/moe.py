"""Mixture-of-Experts with sort-based capacity dispatch — torch port of the
meshless ``'local'`` path of ``repro.models.moe``.

A router picks ``top_k`` experts per token (float32 logits, softmax, top-k,
gates renormalised); the tokens are sorted by expert id (a stable sort, as
``jnp.argsort`` is, so the same tokens drop at capacity) and scattered into
an (E, capacity, d) buffer, rows past an expert's capacity dropped; every
expert's FFN runs as one batched matmul over the buffer (on an enabled
``moe.expert.*`` site one TD-VMM launch with the expert axis on the
kernel's batched grid, ``core.layers.td_expert_matmul``); the outputs
gather back by the inverse permutation and combine with the gates.  Shared
experts (``moe.shared.*``) run on every token.

Two distribution modes under a mesh (``cfg.moe.impl``), as in the JAX
package:

  'local' — experts replicated over the data axes, the expert FFN's hidden
            dim split over ``model``: tokens never leave their data shard,
            and the one collective is the down projection's reduction over
            ``model``.
  'ep'    — expert banks split over the data axes (E / dp local experts),
            hidden dim over ``model``: ``all_to_all_single`` over the data
            axes sends each expert's rows to the rank that owns it and
            routes the outputs back (``_moe_ep``).

Each rank dispatches its own tokens with a capacity computed from its own
token count (GShard's per-shard capacity, the JAX package's semantics), so
drop patterns can differ from the meshless run's; without drops the
results agree.  The aux losses are averaged over the data axes.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core import calibration
from repro_torch.core import layers as td_layers
from repro_torch.core import quant
from repro_torch.launch import meshctx
from repro_torch.models import common


def init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    m = cfg.moe
    d = cfg.d_model
    gated = cfg.act == "silu_glu"
    scale = d ** -0.5

    def normal(shape, s):
        # scaled in place: one float32 bank at a time (22.5 GB for one of
        # kimi-k2's, whose three banks stay resident in bf16)
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device).mul_(s).to(dtype)

    def expert_bank(n):
        p = {"w_up": normal((n, d, m.d_ff), scale),
             "w_down": normal((n, m.d_ff, d), m.d_ff ** -0.5)}
        if gated:
            p["w_gate"] = normal((n, d, m.d_ff), scale)
        return p

    p = {"router": common.dense_init(gen, d, m.n_experts, torch.float32,
                                     device),
         "experts": expert_bank(m.n_experts)}
    if m.n_shared_experts:
        p["shared"] = expert_bank(m.n_shared_experts)
    return p


def _capacity(n_tokens: int, top_k: int, n_experts: int, factor: float) -> int:
    c = int(n_tokens * top_k * factor / n_experts) + 1
    return max(c, 4)


def _expert_ffn(bank, x: torch.Tensor, cfg: ModelConfig, key=None,
                site_prefix: str = "moe.expert") -> torch.Tensor:
    """x: (E, C, d) -> (E, C, d).  Gate and up are two ``<prefix>.in``
    launches, down one ``<prefix>.out`` launch.  Under a tensor-parallel
    mesh the hidden dim is split over ``model``: gate and up are
    column-parallel, down row-parallel (its output summed over
    ``model``)."""
    td_in = cfg.site_tdvmm(site_prefix + ".in")
    td_out = cfg.site_tdvmm(site_prefix + ".out")
    tp = meshctx.tp_active()

    # independent noise per projection (gate, up, down), as the JAX package
    # splits its key
    keys = iter(quant.split_key(key, 3)) if key is not None else None

    def mm(a, wmat, td, mode):
        k = next(keys) if keys is not None and td.enabled else None
        if tp and not td.enabled and mode == "row":
            return common.row_sum(a, wmat)
        return td_layers.td_expert_matmul(a, wmat, td, k,
                                          tp=mode if tp else None)

    if tp:
        x = meshctx.copy_to_tp(x)
    if "w_gate" in bank:
        h = common.activation("silu", mm(x, bank["w_gate"], td_in, "col"))
        h = h * mm(x, bank["w_up"], td_in, "col")
    else:
        h = common.activation(cfg.act, mm(x, bank["w_up"], td_in, "col"))
    return mm(h, bank["w_down"], td_out, "row")


def _route(params, x_flat: torch.Tensor, cfg: ModelConfig):
    """Router: returns (ids (T, K), gates (T, K), aux losses)."""
    m = cfg.moe
    logits = x_flat.to(torch.float32) @ params["router"]["w"]     # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k: descending, the lower index first among equal values
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :m.top_k], ids[:, :m.top_k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    me = torch.mean(probs, dim=0)                                  # (E,)
    counts = torch.zeros((m.n_experts,), dtype=torch.float32,
                         device=x_flat.device).index_add_(
        0, ids.reshape(-1), torch.ones(ids.numel(), dtype=torch.float32,
                                       device=x_flat.device))
    ce = counts / ids.shape[0]
    lb_loss = m.n_experts * torch.sum(me * ce)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return ids, gates.to(x_flat.dtype), {"lb_loss": lb_loss, "z_loss": z_loss}


def _dispatch_indices(ids: torch.Tensor, top_k: int):
    """Sort-based dispatch bookkeeping.

    Returns (sorted_expert, pos_in_expert, order, token_idx): entry j of the
    sorted stream goes to buffer slot [sorted_expert[j], pos_in_expert[j]]
    and came from token token_idx[j]."""
    flat = ids.reshape(-1)                                         # (T*K,)
    sorted_expert, order = torch.sort(flat, stable=True)
    ranks = torch.searchsorted(sorted_expert, sorted_expert, right=False)
    pos = torch.arange(flat.shape[0], device=flat.device) - ranks
    token_idx = torch.div(order, top_k, rounding_mode="floor")
    return sorted_expert, pos, order, token_idx


def _scatter_to_buffer(x_flat, sorted_expert, pos, token_idx, n_experts,
                       capacity) -> torch.Tensor:
    """(E, capacity, d) dispatch buffer; entries past capacity are dropped
    (written to a spare row that is cut off, so no host sync is needed)."""
    d = x_flat.shape[1:]
    buf = torch.zeros((n_experts * capacity + 1,) + d, dtype=x_flat.dtype,
                      device=x_flat.device)
    slot = torch.where(pos < capacity, sorted_expert * capacity + pos,
                       n_experts * capacity)
    buf[slot] = x_flat[token_idx]
    return buf[:n_experts * capacity].reshape((n_experts, capacity) + d)


def _gather_from_buffer(buf, sorted_expert, pos, order, gates,
                        top_k) -> torch.Tensor:
    """Inverse of the scatter; returns the (T, d) combined output.  The
    unsort is a gather by the inverse permutation."""
    cap = buf.shape[1]
    vals = buf[sorted_expert, torch.clamp(pos, max=cap - 1)]      # (T*K, d)
    vals = torch.where((pos < cap)[:, None], vals, 0.0)
    inv_order = torch.argsort(order)
    unsorted = vals[inv_order]
    per_k = unsorted.reshape(-1, top_k, vals.shape[-1])
    return torch.sum(per_k * gates[..., None].to(vals.dtype), dim=1)


def _moe_local(params, x_flat: torch.Tensor, cfg: ModelConfig, key=None):
    """Experts on this device: route, dispatch, expert FFNs, combine."""
    m = cfg.moe
    ids, gates, aux = _route(params, x_flat, cfg)
    cap = _capacity(x_flat.shape[0], m.top_k, m.n_experts, m.capacity_factor)
    se, pos, order, tok = _dispatch_indices(ids, m.top_k)
    buf = _scatter_to_buffer(x_flat, se, pos, tok, m.n_experts, cap)
    out = _expert_ffn(params["experts"], buf, cfg, key)
    y = _gather_from_buffer(out, se, pos, order, gates, m.top_k)
    return y, aux


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over the data axes with equal splits along dim
    0; its gradient takes the same exchange back."""

    @staticmethod
    def forward(ctx, x):
        return _all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g)


def _all_to_all(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=meshctx.dp_group())
    return out


def _ep_windows(cfg: ModelConfig, e_loc: int, device) -> dict:
    """The routed-expert sites' (E,) windows, sliced to this rank's
    experts, as runtime windows (a window tensor installed for the step,
    or a calibrated ``out_scale`` tuple of the plan)."""
    lo = meshctx.dp_rank() * e_loc
    cur = calibration.runtime_window_map() or {}
    out = {}
    for site in ("moe.expert.in", "moe.expert.out"):
        w = cur.get(site)
        if w is None:
            s = cfg.site_tdvmm(site).out_scale
            if isinstance(s, tuple):
                w = torch.as_tensor(np.asarray(s, np.float32),
                                    device=device)
        if w is not None and w.dim() == 1:
            out[site] = w[lo:lo + e_loc]
    return out


def _moe_ep(params, x_flat: torch.Tensor, cfg: ModelConfig, key=None):
    """Experts split over the data axes; ``all_to_all_single`` routes each
    expert's rows to its owner and the outputs back."""
    m = cfg.moe
    dp = meshctx.dp_size()
    if m.n_experts % dp:
        raise ValueError(f"{m.n_experts} experts do not split over {dp} "
                         "data ranks (moe.impl='ep')")
    e_loc = m.n_experts // dp
    ids, gates, aux = _route(params, x_flat, cfg)
    cap = _capacity(x_flat.shape[0], m.top_k, m.n_experts, m.capacity_factor)
    se, pos, order, tok = _dispatch_indices(ids, m.top_k)
    # send buffer grouped by destination rank: (E, C, d) == (dp, E_loc, C, d)
    buf = _scatter_to_buffer(x_flat, se, pos, tok, m.n_experts, cap)
    buf = _AllToAll.apply(buf)
    # (dp_src, E_loc, C, d): every source rank's rows for my experts
    d = buf.shape[-1]
    buf = buf.reshape(dp, e_loc, cap, d).transpose(0, 1).reshape(
        e_loc, dp * cap, d)
    wins = _ep_windows(cfg, e_loc, buf.device)
    # the buffer holds every data rank's rows for these experts
    with calibration.runtime_windows(wins or None), \
            meshctx.split_rows(False):
        out = _expert_ffn(params["experts"], buf, cfg, key)
    out = out.reshape(e_loc, dp, cap, d).transpose(0, 1).reshape(
        m.n_experts, cap, d)
    out = _AllToAll.apply(out)
    y = _gather_from_buffer(out, se, pos, order, gates, m.top_k)
    return y, aux


def apply(params, x: torch.Tensor, cfg: ModelConfig,
          key=None) -> tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (y, aux losses).  ``key`` (an int seed) draws
    programming noise at the expert sites whose config sets ``noise``; the
    aux losses (``lb_loss``, ``z_loss``) carry gradients to the router.
    Under a mesh ``x`` holds this rank's rows and the expert banks its
    shards (``launch.sharding``)."""
    m = cfg.moe
    b, s, d = x.shape

    def noisy(prefix):
        return any(td.enabled and td.noise for td in
                   (cfg.site_tdvmm(prefix + ".in"),
                    cfg.site_tdvmm(prefix + ".out")))

    # routed and shared experts draw independent noise
    k_shared = k_routed = None
    if key is not None and (noisy("moe.expert") or noisy("moe.shared")):
        k_shared, k_routed = quant.split_key(key, 2)
    shared_y = 0.0
    if m.n_shared_experts:
        shared_y = _expert_ffn(params["shared"], x.reshape(1, b * s, d), cfg,
                               k_shared, site_prefix="moe.shared"
                               ).reshape(b, s, d)
    if meshctx.get_mesh() is not None and m.impl == "ep" \
            and meshctx.dp_active():
        if k_routed is not None:
            # each rank owns different experts: fold the rank in so they
            # draw independent noise (the replicated 'local' experts must
            # draw the same noise everywhere, so they do not fold)
            k_routed = quant.fold_in(k_routed, meshctx.dp_rank())
        y, aux = _moe_ep(params, x.reshape(-1, d), cfg, k_routed)
    else:
        y, aux = _moe_local(params, x.reshape(-1, d), cfg, k_routed)
    if meshctx.dp_active():
        # the value is the mean over the data axes; the gradient is this
        # rank's own, which the data-parallel gradient average then means
        aux = {k: v + (meshctx.dp_mean(v) - v).detach()
               for k, v in aux.items()}
    return y.reshape(b, s, d) + shared_y, aux
