"""What decides ``correct`` for a served model: the served tokens and, where
the timed path hands them back, the served logits, against the plain
reference.

For every sampled request the reference runs once over its prompt and its
served tokens.  At each served token it reads the gap by which that
token's logit lies below the reference's best logit at the same position
(0 where the served token is the reference's own greedy choice), and where
the program's logits at that position were kept, their distance from the
reference's.  The numbers (each compared with its limit in
``perfbench/limits/<cell>.json`` where the limits file gives one):

    gap_max    the widest gap over every served token judged
    gap_mean   the mean gap over them
    logit_err  the root mean square of (program - reference) logits over
               the reference's root mean square, over every kept row

The control puts the reference computed in float8 in the program's place:
at the same prompts and positions its first token's gap and its logits'
distance, under the reference at the stated precision.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.lm import Reference


def _seqs(samples: list[dict], device) -> list[tuple[torch.Tensor, int]]:
    """(token ids of prompt + served tokens but the last, prompt length)."""
    out = []
    for s in samples:
        ids = np.concatenate([np.asarray(s["prompt"], np.int64),
                              np.asarray(s["tokens"][:-1], np.int64)])
        out.append((torch.as_tensor(ids, device=device), len(s["prompt"])))
    return out


def _logits_at_served(ref: Reference, block, vocab: int):
    """For each sequence of ``block``: the reference's logits at the
    positions that produced the served tokens (prompt_len - 1 onwards)."""
    hs = ref.hidden([ids for ids, _ in block])
    return [ref.logits(h[p - 1:], vocab) for h, (_, p) in zip(hs, block)]


def compare(ref: Reference, samples: list[dict], vocab: int, device,
            other: Reference | None = None, block: int = 8) -> dict:
    """{"gaps": every served token's gap, "err2", "ref2": the summed
    squares of the logit differences and of the reference's logits over
    the rows whose program logits were kept}.  With ``other``, its first
    token and its logits stand in for the program's."""
    seqs = _seqs(samples, device)
    gaps, err2, ref2 = [], 0.0, 0.0
    for lo in range(0, len(seqs), block):
        blk = seqs[lo:lo + block]
        mine = _logits_at_served(ref, blk, vocab)
        theirs = None if other is None else \
            _logits_at_served(other, blk, vocab)
        for j, lg in enumerate(mine):
            s = samples[lo + j]
            if theirs is None:
                tok = torch.as_tensor(s["tokens"], device=lg.device)
                got = s.get("logits")
            else:
                got = theirs[j]
                tok = got.argmax(dim=-1)
            best = lg.max(dim=-1).values
            at = lg.gather(1, tok.long()[:, None])[:, 0]
            gaps.append((best - at).double().cpu().numpy())
            if got is not None:
                got = got.to(lg.device, torch.float32)[:, :vocab]
                err2 += float(((got - lg) ** 2).double().sum())
                ref2 += float((lg ** 2).double().sum())
        del mine, theirs
    return {"gaps": np.concatenate(gaps) if gaps else np.zeros(0),
            "err2": err2, "ref2": ref2}


def spread(g: np.ndarray) -> dict:
    """How the gaps lie (reported, not compared)."""
    if g.size == 0:
        return {"n": 0}
    return {"n": int(g.size), "nonzero": int(np.count_nonzero(g)),
            "p99": float(np.percentile(g, 99)), "p90": float(
                np.percentile(g, 90))}


def numbers(c: dict) -> dict:
    """The numbers of a comparison."""
    g = c["gaps"]
    if g.size == 0 or not np.all(np.isfinite(g)):
        out = {"gap_max": float("inf"), "gap_mean": float("inf")}
    else:
        out = {"gap_max": float(g.max()), "gap_mean": float(g.mean())}
    if c["ref2"] > 0:
        out["logit_err"] = float(np.sqrt(c["err2"] / c["ref2"])) \
            if np.isfinite(c["err2"]) else float("inf")
    return out
