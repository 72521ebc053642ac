"""Batched serving with a slot manager, on the card (the port's counterpart
of ``examples/serve_lm.py``): prefill + decode over dense KV caches, where
requests of different lengths enter and leave a fixed-size decode batch.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm [--device cpu] \\
        [--seed 0]

The FFN matmuls run as calibrated TD-VMM tiles through the site plan:
``ffn.*`` sites are addressed with one glob rule, ``ffn.in`` chains into
``ffn.out`` in the time domain (Fig. 2: the intermediate p-bit readout
disappears), and one model-wide calibration pass pins the remaining digital
site's readout window.  On the card the calibration runs kernels B1 raw and
B2, the steps B1 fused.

A request is admitted by a one-request ``prefill_step`` whose cache is
merged into the batch cache at its slot; then every slot advances by
batched ``decode_step``s until its budget is spent.  The model is the
smoke qwen1.5-0.5b with random weights (``--seed``), calibrated on a
(4, 16) prompt drawn from a CPU ``torch.Generator`` seeded with ``--seed``
+ 1; ``run`` takes both as arguments instead (a test passes the JAX
example's own).  The 10 requests come from ``np.random.default_rng(seed)``,
the JAX example's draws at seed 0.  Without a card it raises unless given
``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import TDVMMPlan, get_config, smoke, tdvmm_rule
from repro_torch.models import common, model

ARCH = "qwen1.5-0.5b"
BATCH_SLOTS = 4
MAX_LEN = 64
REQUESTS = 10
CALIB_PROMPT = 16


def config():
    """The smoke qwen with ffn.* as TD-VMM tiles, ffn.in chained."""
    return smoke(get_config(ARCH)).replace(tdvmm_plan=TDVMMPlan(rules=(
        tdvmm_rule("ffn.*", enabled=True, backend="auto"),
        tdvmm_rule("ffn.in", chain=True),
    )))


def make_requests(vocab: int, seed: int = 0) -> list[tuple[np.ndarray, int]]:
    """(prompt tokens, tokens to generate) of every request: the JAX
    example's draws."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=rng.integers(4, 12)),
             int(rng.integers(8, 20))) for _ in range(REQUESTS)]


def _merge(caches: dict, one: dict, slot: int) -> None:
    """Write a one-request cache into the batch cache at ``slot``: every
    leaf is (L, B, ...) against (L, 1, ...)."""
    for name, seg in caches.items():
        for whole, part in zip(seg, one[name]):
            if whole is not None:
                whole[:, slot] = part[:, 0]


@torch.no_grad()
def run(device=None, seed: int = 0, params=None, calib_tokens=None) -> dict:
    """Serve the requests on ``device`` (the card unless given); prints the
    JAX example's lines and returns each request's tokens, the total, the
    decode steps and the seconds."""
    device = common.resolve_device(device)
    cfg = config()
    print("TD-VMM plan:")
    print(cfg.resolved_tdvmm_plan.describe())
    if params is None:
        params = model.init_params(seed, cfg, device=device)
    if calib_tokens is None:
        g = torch.Generator().manual_seed(seed + 1)
        calib_tokens = torch.randint(0, cfg.vocab_size,
                                     (BATCH_SLOTS, CALIB_PROMPT), generator=g)
    calib = model.calibrate(params, {"inputs": calib_tokens}, cfg,
                            max_len=MAX_LEN, device=device)
    print("calibrated sites:", calib.sites())

    requests = make_requests(cfg.vocab_size, seed)
    caches = model.init_caches(cfg, BATCH_SLOTS, MAX_LEN, device)
    slot_remaining = [0] * BATCH_SLOTS
    slot_request = [None] * BATCH_SLOTS
    cur_tok = torch.zeros((BATCH_SLOTS, 1), dtype=torch.long, device=device)
    outputs = {i: [] for i in range(len(requests))}
    pending = list(enumerate(requests))
    done = steps = 0
    t0 = time.perf_counter()

    def admit(slot: int) -> None:
        rid, (prompt, gen) = pending.pop(0)
        one = model.init_caches(cfg, 1, MAX_LEN, device)
        prompt = torch.as_tensor(prompt, device=device)[None, :]
        logits, one = model.prefill_step(params, {"inputs": prompt}, one, cfg,
                                         calib=calib)
        tok = torch.argmax(logits[0, -1, :cfg.vocab_size])
        _merge(caches, one, slot)
        cur_tok[slot, 0] = tok
        slot_remaining[slot] = gen
        slot_request[slot] = rid
        outputs[rid].append(int(tok))

    while done < len(requests):
        for s in range(BATCH_SLOTS):
            if slot_remaining[s] == 0 and pending:
                admit(s)
        logits, caches = model.decode_step(params, {"inputs": cur_tok},
                                           caches, cfg, calib=calib)
        steps += 1
        nxt = torch.argmax(logits[:, 0, :cfg.vocab_size], dim=-1)
        cur_tok = nxt[:, None]
        nxt = nxt.tolist()
        for s in range(BATCH_SLOTS):
            if slot_remaining[s] > 0:
                outputs[slot_request[s]].append(nxt[s])
                slot_remaining[s] -= 1
                if slot_remaining[s] == 0:
                    done += 1

    dt = time.perf_counter() - t0
    total_tokens = sum(len(v) for v in outputs.values())
    print(f"served {len(requests)} requests, {total_tokens} tokens in "
          f"{dt:.1f}s ({steps} decode steps, batch={BATCH_SLOTS})")
    for rid in sorted(outputs)[:3]:
        print(f"  req {rid}: {outputs[rid][:10]}...")
    if not all(outputs.values()):
        raise RuntimeError("a request produced no token")
    return {"outputs": outputs, "total_tokens": total_tokens,
            "steps": steps, "seconds": dt, "calibration": calib}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain torch path; default: the card")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    return run(args.device, args.seed)


if __name__ == "__main__":
    main()
