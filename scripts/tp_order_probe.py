#!/usr/bin/env python3
"""Which of the dense qwen1.5-0.5b step's digital ops give, on a tensor-
parallel shard of two, the bits of the meshless op on the card; and what the
row-parallel float32 reduction costs.

    python3 scripts/tp_order_probe.py [--out FILE]

One process, one card, bf16, no process group: a shard is computed on its
slice of the operands, as a rank of a 1 x 2 mesh computes it.
- Column-parallel products (qkv members K 1024 x N 1024, the FFN's gate/up
  N 2816, the vocab head N 151,936, and the tied head ``x @ table.T`` over
  the (151,936, 1024) embedding table) at M 4 (a decode step of 4 slots),
  64 (a prefill chunk) and 256 (4 x 64 prompts): does each half of
  ``x @ w`` equal ``x @ w_half``?
- Attention (``models.attention._attend``'s einsums) at 8 of qwen's 16 heads
  against those heads of the 16-head call, decode (1 query, 80 keys) and
  prefill (64 queries and keys).
- kimi-k2's KV-group split over a model axis of 16 (``attn_split``
  "groups"): the column products at K 7168 (``wq`` N 7168 in 16 slices of
  448, ``wk`` N 896 in its 8 KV heads of 112) at M 4, 64 and 2048, and
  attention at 4 of its 64 query heads with their one KV head of 8 against
  those heads of the whole call, decode (1 query, 520 keys) and prefill
  (512 queries and keys), causal.
- Row-parallel products (attn.wo K 1024, ffn.w_down K 2816, N 1024): the
  meshless bf16 matmul, against the two halves' float32 partial products
  summed in rank order and rounded once, computed (a) from float32 copies of
  the operands and (b) by the bf16 tensor cores with float32 output
  (``torch.mm(..., out_dtype=torch.float32)``): how many elements differ,
  and whether (a) and (b) agree.
- The cost of (a), (b) and the bf16 matmul at one yi-34b ffn.w_down shard
  (K 20480 / 2, N 7168) and at qwen's attn.wo shard, M 256, CUDA events.
Prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess


def _equal(a, b) -> bool:
    import torch
    return bool(torch.equal(a, b))


def _time(fn, reps: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(True), torch.cuda.Event(True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale
                ).bfloat16()

    res = {"device": torch.cuda.get_device_name(0),
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip(),
           "torch": torch.__version__}
    col = {}
    for name, k, n in (("qkv", 1024, 1024), ("ffn_in", 1024, 2816),
                       ("head", 1024, 151936)):
        w = rnd(k, n, scale=k ** -0.5)
        for m in (4, 64, 256):
            x = rnd(m, k)
            full = x @ w
            h = n // 2
            col[f"{name} M{m}"] = (
                _equal(full[:, :h], x @ w[:, :h].contiguous())
                and _equal(full[:, h:], x @ w[:, h:].contiguous()))
    table = rnd(151936, 1024)
    for m in (4, 64, 256):
        x = rnd(m, 1024)
        full = x @ table.T
        col[f"tied_head M{m}"] = all(
            _equal(full[:, i * 75968:(i + 1) * 75968],
                   x @ table[i * 75968:(i + 1) * 75968].T) for i in (0, 1))
    res["column_halves_bitwise"] = col

    att = {}
    for name, b, sq, skv in (("decode", 4, 1, 80), ("prefill", 1, 64, 64)):
        q, kk, v = rnd(b, sq, 16, 64), rnd(b, skv, 16, 64), rnd(b, skv, 16, 64)

        def attend(q, k, v):
            lg = torch.einsum("bskgd,btkd->bkgst", q[:, :, :, None], k
                              ).to(torch.float32) * 64 ** -0.5
            p = torch.softmax(lg, dim=-1).to(v.dtype)
            return torch.einsum("bkgst,btkd->bskgd", p, v)[:, :, :, 0]
        full = attend(q, kk, v)
        att[name] = all(_equal(full[:, :, i * 8:(i + 1) * 8], attend(
            q[:, :, i * 8:(i + 1) * 8].contiguous(),
            kk[:, :, i * 8:(i + 1) * 8].contiguous(),
            v[:, :, i * 8:(i + 1) * 8].contiguous())) for i in (0, 1))
    res["attention_heads_bitwise"] = att

    kimi = {}
    for name, n, parts in (("wq", 7168, 16), ("wk", 896, 8)):
        w = rnd(7168, n, scale=7168 ** -0.5)
        for m in (4, 64, 2048):
            x = rnd(m, 7168)
            full = x @ w
            c = n // parts
            kimi[f"{name} M{m}"] = all(
                _equal(full[:, i * c:(i + 1) * c],
                       x @ w[:, i * c:(i + 1) * c].contiguous())
                for i in range(parts))

    def gqa(q, k, v, causal):
        b, sq, h, d = q.shape
        kv = k.shape[2]
        qg = q.reshape(b, sq, kv, h // kv, d)
        lg = torch.einsum("bskgd,btkd->bkgst", qg, k).to(torch.float32) \
            * d ** -0.5
        if causal:
            t = k.shape[1]
            mask = torch.arange(t, device=dev)[None, :] <= (
                torch.arange(sq, device=dev)[:, None] + t - sq)
            lg = torch.where(mask, lg, -1e30)
        p = torch.softmax(lg, dim=-1).to(v.dtype)
        return torch.einsum("bkgst,btkd->bskgd", p, v).reshape(b, sq, h, d)
    for name, b, sq, skv in (("decode", 4, 1, 520), ("prefill", 4, 512,
                                                     512)):
        q = rnd(b, sq, 64, 112)
        kk, v = rnd(b, skv, 8, 112), rnd(b, skv, 8, 112)
        full = gqa(q, kk, v, True)
        kimi[f"attention {name}"] = all(_equal(
            full[:, :, 4 * r:4 * r + 4],
            gqa(q[:, :, 4 * r:4 * r + 4].contiguous(),
                kk[:, :, r // 2:r // 2 + 1].contiguous(),
                v[:, :, r // 2:r // 2 + 1].contiguous(), True))
            for r in range(16))
    res["kimi_groups_bitwise"] = kimi

    row = {}
    try:
        torch.mm(rnd(4, 8), rnd(8, 4), out_dtype=torch.float32)
        res["mm_out_dtype"] = True
    except Exception as e:                             # noqa: BLE001
        res["mm_out_dtype"] = f"{type(e).__name__}: {e}"[:200]
    for name, k in (("wo", 1024), ("w_down", 2816)):
        w = rnd(k, 1024, scale=k ** -0.5)
        for m in (4, 64, 256):
            x = rnd(m, k)
            full = x @ w
            h = k // 2
            xs = [x[:, :h].contiguous(), x[:, h:].contiguous()]
            ws = [w[:h].contiguous(), w[h:].contiguous()]
            up = (xs[0].float() @ ws[0].float()) \
                + (xs[1].float() @ ws[1].float())
            r = {"n": full.numel(),
                 "upcast_vs_meshless": int((up.bfloat16() != full).sum())}
            if res["mm_out_dtype"] is True:
                tc = torch.mm(xs[0], ws[0], out_dtype=torch.float32) \
                    + torch.mm(xs[1], ws[1], out_dtype=torch.float32)
                r["out_dtype_vs_meshless"] = int((tc.bfloat16() != full)
                                                 .sum())
                r["out_dtype_vs_upcast"] = int((tc.bfloat16()
                                                != up.bfloat16()).sum())
            row[f"{name} M{m}"] = r
    res["row_halves"] = row

    cost = {}
    for name, k, n in (("yi34b_w_down_shard", 10240, 7168),
                       ("qwen_wo_shard", 512, 1024)):
        x, w = rnd(256, k), rnd(k, n, scale=k ** -0.5)
        c = {"bf16_mm_ms": _time(lambda: x @ w),
             "upcast_f32_ms": _time(lambda: x.float() @ w.float())}
        if res["mm_out_dtype"] is True:
            c["out_dtype_ms"] = _time(
                lambda: torch.mm(x, w, out_dtype=torch.float32))
        cost[name] = c
    res["row_cost_m256"] = cost
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
