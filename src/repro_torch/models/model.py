"""LM wrapper: embedding, stack, head; the training forward and loss
(``forward``, ``loss_fn``) and the serving entry points — torch port of
``repro.models.model`` (dense, MoE, SSM and hybrid models; the paged steps
serve the attention families, dense and MoE, without a sliding window, as
the JAX package's do).

Parameters are a plain dict::

    {"embed": {"table": (V_pad, d)},
     "blocks": {"seg0": [layer params, ...],
                "shared_attn": {...}, "fuse": {"w": (2d, d)}},  # hybrid
     "ln_f": {"scale": (d,)},
     "head": {"w": (d, V_pad)}}          # absent with tied embeddings

``init_params`` draws them from a seeded ``torch.Generator`` on the target
device; ``repro_torch.convert.params_from_numpy`` builds the same structure
from the JAX package's parameters.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import calibration
from repro_torch.launch import meshctx
from repro_torch.models import attention, common, ssm, transformer
from repro_torch.runtime.paged_cache import DecodeCtx, PrefillChunkCtx
from repro_torch.runtime.trace import span


def init_params(seed: int, cfg: ModelConfig, device=None) -> dict:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``, on
    the card unless ``device`` says otherwise (raises with no card)."""
    device = common.resolve_device(device)
    dtype = common.resolve_dtype(cfg.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params: dict[str, Any] = {}
    if cfg.input_mode == "tokens":
        table = torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen,
                            dtype=torch.float32, device=device) * 0.02
        params["embed"] = {"table": table.to(dtype)}
    params["blocks"] = transformer.init(gen, cfg, dtype, device)
    params["ln_f"] = common.rmsnorm_init(cfg.d_model, dtype, device)
    if not cfg.tie_embeddings:
        params["head"] = common.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                           dtype, device,
                                           scale=cfg.d_model ** -0.5)
    return params


def param_device(params) -> torch.device:
    return params["ln_f"]["scale"].device


def check_device(params, device=None) -> torch.device:
    """Resolve an entry point's device and require the params to live there."""
    device = common.resolve_device(device)
    have = param_device(params)
    if have.type != device.type or (
            device.index is not None and have.index != device.index):
        raise ValueError(f"params live on {have}, the entry point runs on "
                         f"{device}")
    return have


def _embed(params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.input_mode != "tokens":
        return batch["inputs"].to(common.resolve_dtype(cfg.dtype))
    table = params["embed"]["table"]
    ids = batch["inputs"].long()
    if not meshctx.tp_active():
        return table[ids]
    # vocab split over ``model``: each rank looks up the ids it holds (zero
    # rows elsewhere) and the sum over ``model`` is exact (one nonzero term)
    rows = table.shape[0]
    local = ids - meshctx.tp_rank() * rows
    mine = (local >= 0) & (local < rows)
    x = torch.where(mine[..., None], table[local.clamp(0, rows - 1)],
                    torch.zeros((), dtype=table.dtype, device=table.device))
    return meshctx.reduce_from_tp(x)


def _head(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits over the whole (padded) vocab; under tensor parallelism each
    rank computes its vocab columns and they are all-gathered, so a greedy
    argmax breaks ties at the lowest index as the meshless one does."""
    if cfg.tie_embeddings:
        y = meshctx.copy_to_tp(x) @ params["embed"]["table"].T
    else:
        y = common.dense(params["head"], x, cfg.site_tdvmm("head"))
    return meshctx.gather_from_tp(y, -1)


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------
def forward(params, batch: dict, cfg: ModelConfig, key=None):
    """Training forward: full-sequence causal.  Returns (logits (B, S, V),
    aux losses).  ``key`` (an int seed) draws programming noise at the
    TD-VMM sites whose config sets ``noise``.

    Under a mesh ``params`` are this rank's shards in the compute layout
    (``launch.sharding.param_specs(..., dp_axes=())``: TP and EP split, no
    FSDP) and ``batch`` is the global batch: each rank runs its rows
    (``common.constrain_batch``) and the logits come back whole."""
    inputs = batch["inputs"]
    local = common.constrain_batch(inputs)
    with meshctx.split_rows(local.shape[0] != inputs.shape[0]):
        logits, aux = _forward(params, {"inputs": local},
                               meshctx.local_config(cfg), key)
    return meshctx.dp_gather(logits, inputs.shape[0]), aux


def _forward(params, batch: dict, cfg: ModelConfig, key=None):
    """``forward`` on the rows it is given, with a shard's config."""
    x = _embed(params, batch, cfg)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    x, aux = transformer.apply_train(params["blocks"], x, cfg, positions, key,
                                     embed0=x)
    x = common.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return _head(params, x, cfg), aux


def loss_fn(params, batch: dict, cfg: ModelConfig, key=None,
            lb_coef: float = 0.01, z_coef: float = 1e-3):
    """Next-token cross-entropy with a padding mask; targets (B, S), the
    positions with target < 0 masked out.  Returns (total loss, metrics):
    the total adds ``lb_coef`` x the load-balance and ``z_coef`` x the
    router z loss; metrics hold the loss, both aux losses and the token
    count (all float32 tensors).  Under a mesh ``batch`` holds this rank's
    rows (the training step splits the global batch)."""
    logits, aux = _forward(params, batch, meshctx.local_config(cfg), key)
    targets = torch.as_tensor(batch["targets"], device=logits.device)
    mask = (targets >= 0).to(torch.float32)
    safe_t = torch.clamp_min(targets, 0).long()
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    # the gold logit by index (its backward accumulates deterministically on
    # the card, where gather's would scatter with atomics)
    flat = logits.reshape(-1, logits.shape[-1])
    gold = flat[torch.arange(flat.shape[0], device=flat.device),
                safe_t.reshape(-1)].reshape(safe_t.shape)
    nll = (logz - gold) * mask
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = nll.sum() / denom
    total = loss + lb_coef * aux["lb_loss"] + z_coef * aux["z_loss"]
    metrics = {"loss": loss, "lb_loss": aux["lb_loss"],
               "z_loss": aux["z_loss"], "tokens": mask.sum()}
    return total, metrics


# --------------------------------------------------------------------------
# Dense-cache serving (calibration pass and the solo greedy oracle)
# --------------------------------------------------------------------------
def _stack(one, n: int):
    """n copies of a one-layer cache along a new leading axis."""
    return type(one)(*(None if t is None else
                       t.unsqueeze(0).repeat((n,) + (1,) * t.dim())
                       for t in one))


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    """Stacked caches, one leading layer axis per segment: KV caches of the
    attention segments {"seg<i>": KVCache((L, B, S, kv, hd) x 2, pos (L, B))}
    (S = min(max_len, window) for a sliding window; int8 codes plus
    (L, B, S, kv) float32 scales under ``attention.set_kv_cache_int8``), SSM
    caches {"seg<i>": SSMCache(conv (L, B, d_conv-1, C), state (L, B, H, P,
    S), pos (L, B))} (``max_len`` does not size an SSM cache); the hybrid
    family's SSM layers the same, and its shared block one KV cache per
    group, {"shared_attn": KVCache((G, B, S, kv, hd) ...)}.  Under a mesh
    the caches of this rank's shard: ``batch`` of its rows, its KV heads."""
    cfg = meshctx.local_config(cfg)
    dtype = common.resolve_dtype(cfg.dtype)
    caches = {}
    for i, (kind, n) in enumerate(transformer.segments(cfg)):
        if kind in ("ssm", "hybrid"):
            one = ssm.init_cache(cfg, batch, dtype, device)
        else:
            one = attention.init_cache(cfg, batch, max_len, dtype, device)
        caches[f"seg{i}"] = _stack(one, n)
        if kind == "hybrid" and cfg.hybrid_attn_every:
            groups, _ = transformer.hybrid_groups(cfg, n)
            caches["shared_attn"] = _stack(attention.init_cache(
                cfg, batch, max_len, dtype, device), groups)
    return caches


def prefill_step(params, batch: dict, caches: dict, cfg: ModelConfig,
                 calib=None):
    """Absorb a prompt.  Returns (logits at the last position (B, 1, V),
    caches).  ``calib`` (a ``CalibrationState``) pins each TD-VMM site's
    readout window."""
    with span("model.prefill"):
        cfg = meshctx.local_config(calibration.apply_calibration(cfg, calib))
        x = _embed(params, batch, cfg)
        x, caches = transformer.apply(params["blocks"], x, cfg, "prefill",
                                      caches, embed0=x)
        x = common.rmsnorm(params["ln_f"], x[:, -1:], cfg.norm_eps)
        return _head(params, x, cfg), caches


def decode_step(params, batch: dict, caches: dict, cfg: ModelConfig,
                calib=None):
    """One token for every sequence, batch['inputs']: (B, 1).  Returns
    (logits (B, 1, V), caches)."""
    with span("model.decode"):
        cfg = meshctx.local_config(calibration.apply_calibration(cfg, calib))
        x = _embed(params, batch, cfg)
        x, caches = transformer.apply(params["blocks"], x, cfg, "decode",
                                      caches, embed0=x)
        x = common.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        return _head(params, x, cfg), caches


# --------------------------------------------------------------------------
# Paged serving (continuous-batching engine, runtime/engine.py)
# --------------------------------------------------------------------------
def init_paged_caches(cfg: ModelConfig, num_pages: int, page_size: int,
                      device, ranks: int = 1) -> dict:
    """Stacked page pools for every attention layer: {"seg<i>":
    PagedKVCache((L, R, page_size, kv, hd) x 2)} with R = ranks x
    (num_pages + 1) rows, int8 codes plus (L, R, page_size, kv) float32
    scales under ``attention.set_kv_cache_int8``.  All layers share one
    logical page allocation; ``ranks`` > 1 is the engine's data-parallel
    pool (``PagePool(ranks=)``: one region of num_pages + 1 rows per rank).
    Under a mesh the pools hold this rank's KV heads."""
    if cfg.family not in ("dense", "moe", "vlm", "audio"):
        raise NotImplementedError(
            f"paged serving supports attention families, not "
            f"{cfg.family!r} (SSM and hybrid state is O(1) per slot: use "
            "the static path, launch.serve --static)")
    cfg = meshctx.local_config(cfg)
    dtype = common.resolve_dtype(cfg.dtype)
    caches = {}
    for i, (_, n) in enumerate(transformer.segments(cfg)):
        caches[f"seg{i}"] = _stack(attention.init_paged_cache(
            cfg, ranks * (num_pages + 1) - 1, page_size, dtype, device), n)
    return caches


def prefill_chunk(params, batch: dict, caches: dict, cfg: ModelConfig,
                  calib=None, windows=None):
    """One fixed-shape prefill chunk for ONE slot (the engine's first step).
    batch: {"inputs": (1, C), "block_row": (P,), "offset": (), "valid": ()}
    tensors.  Returns (logits at the last valid position (1, 1, V), caches);
    the page pools are written in place.  ``windows`` (site -> float32
    window tensor, ``CalibrationState.as_arrays()``) are the pinned readout
    windows as operands."""
    with span("model.prefill"):
        cfg = meshctx.local_config(calibration.apply_calibration(cfg, calib))
        ctx = PrefillChunkCtx(block_row=batch["block_row"],
                              offset=batch["offset"], valid=batch["valid"])
        with calibration.runtime_windows(windows):
            x = _embed(params, batch, cfg)
            x, caches = transformer.apply(params["blocks"], x, cfg,
                                          "prefill_paged", caches,
                                          page_ctx=ctx)
            last = (ctx.valid - 1).reshape(1).long()
            x = torch.index_select(x, 1, last)
            x = common.rmsnorm(params["ln_f"], x, cfg.norm_eps)
            return _head(params, x, cfg), caches


def decode_slots(params, batch: dict, caches: dict, cfg: ModelConfig,
                 calib=None, windows=None):
    """One token for every slot (the engine's second step).  batch:
    {"inputs": (B, 1), "block_tables": (B, P), "pos": (B,), "active": (B,)}
    tensors.  Returns (logits (B, 1, V), caches); inactive rows produce
    ignored logits.  ``windows`` as in ``prefill_chunk``."""
    with span("model.decode"):
        cfg = meshctx.local_config(calibration.apply_calibration(cfg, calib))
        ctx = DecodeCtx(block_tables=batch["block_tables"], pos=batch["pos"],
                        active=batch["active"])
        with calibration.runtime_windows(windows):
            x = _embed(params, batch, cfg)
            x, caches = transformer.apply(params["blocks"], x, cfg,
                                          "decode_paged", caches, page_ctx=ctx)
            x = common.rmsnorm(params["ln_f"], x, cfg.norm_eps)
            return _head(params, x, cfg), caches


@torch.no_grad()
def calibrate(params, batch: dict, cfg: ModelConfig, max_len: int = 0,
              device=None) -> calibration.CalibrationState:
    """Model-wide §3.1 readout-window calibration (one prefill pass).

    Runs ``prefill_step`` over a representative batch with the calibration
    collector installed: every enabled, digital-boundary TD-VMM site records
    the max|z| of its latch-normalized accumulation (layers sharing a site
    max-merge).  On the card, unpinned sites run the data-calibrated readout
    (kernel B2) and the capture runs B1 in raw mode."""
    device = check_device(params, device)
    inputs = torch.as_tensor(batch["inputs"], device=device)
    b, s = inputs.shape[:2]
    caches = init_caches(cfg, b, max_len or s, device)
    with calibration.collect() as collected:
        prefill_step(params, {"inputs": inputs}, caches, cfg)
    return calibration.CalibrationState.from_collected(collected)


@torch.no_grad()
def drift_probe(params, batch: dict, cfg: ModelConfig,
                pinned: calibration.CalibrationState, max_len: int = 0,
                device=None) -> tuple[calibration.CalibrationState,
                                      dict[str, float]]:
    """One calibration pass measured against pinned windows.

    The capture of ``calibrate`` with clip tracking on: every site also
    tallies how many of its latch-normalized |z| elements exceed the window
    pinned for serving (``pinned``).  Returns ``(fresh, clip_rates)``: the
    freshly captured ``CalibrationState`` and site -> clip fraction, the two
    signals the engine's drift check thresholds.  It runs outside the
    engine's two step programs (on the card: B1 raw at every capture, B2 at
    every site, whose windows this pass does not pin)."""
    device = check_device(params, device)
    inputs = torch.as_tensor(batch["inputs"], device=device)
    b, s = inputs.shape[:2]
    caches = init_caches(cfg, b, max_len or s, device)
    with calibration.collect(pinned=pinned.as_arrays(device)) as collected:
        prefill_step(params, {"inputs": inputs}, caches, cfg)
    fresh = calibration.CalibrationState.from_collected(collected)
    return fresh, calibration.clip_rates(calibration.last_clips() or {})
