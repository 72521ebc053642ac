"""The one general traffic generator.  A mix is a data file
(``perfbench/traffic/<mix>.json``) of parameters; every draw comes from the
run's ``--seed``.

Sizes never depend on the seed: lengths are fixed quantiles of the mix's
distribution, and the seed only orders them and draws the token ids, so
every seed offers the same amount of work (copied pattern: the Zipf ids of
``repro_torch.data.pipeline.SyntheticLM``; the ragged trace of
``repro_torch.launch.serve.make_trace``).
"""
from __future__ import annotations

import math

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent stream of draws for one purpose of one run."""
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


def zipf_ids(r: np.random.Generator, shape, a: float, vocab: int
             ) -> np.ndarray:
    """Token ids drawn Zipf(a) over the vocabulary, clipped to its end."""
    toks = r.zipf(a, size=shape).astype(np.int64)
    return np.minimum(toks - 1, vocab - 1).astype(np.int64)


def quantiles(spec: dict, n: int) -> list[int]:
    """``n`` fixed lengths spread over a distribution, {"dist": "uniform",
    "lo", "hi"} or {"dist": "loguniform", "lo", "hi"}, at the midpoints of
    n equal-probability bins."""
    lo, hi = float(spec["lo"]), float(spec["hi"])
    mids = [(i + 0.5) / n for i in range(n)]
    if spec["dist"] == "uniform":
        return [int(round(lo + (hi - lo) * u)) for u in mids]
    if spec["dist"] == "loguniform":
        return [int(round(math.exp(math.log(lo)
                                   + (math.log(hi) - math.log(lo)) * u)))
                for u in mids]
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def requests(mix: dict, seed: int, vocab: int) -> list[dict]:
    """A backlog of ``mix["rounds"]`` rounds of ``mix["per_round"]``
    requests; each round holds the same prompt and output lengths, paired
    and ordered by the seed.  Returns [{"rid", "prompt", "max_new"}]."""
    n = mix["per_round"]
    plens = quantiles(mix["prompt_len"], n)
    glens = quantiles(mix["output_len"], n)
    r = rng(seed, 1)
    out = []
    for _ in range(mix["rounds"]):
        for p, g in zip(r.permutation(plens), r.permutation(glens)):
            out.append({"rid": len(out),
                        "prompt": zipf_ids(r, (int(p),), mix["zipf"], vocab),
                        "max_new": int(g)})
    return out


def batches(mix: dict, seed: int, vocab: int, index: int) -> np.ndarray:
    """Batch ``index`` of a static mix: (batch, prompt_len) Zipf ids."""
    r = rng(seed, 1000 + index)
    return zipf_ids(r, (mix["batch"], mix["prompt_len"]), mix["zipf"], vocab)


def calibration_batch(mix: dict, seed: int, vocab: int) -> np.ndarray:
    """The one batch the readout windows are calibrated on."""
    c = mix["calibration"]
    return zipf_ids(rng(seed, 2), (c["batch"], c["len"]), mix["zipf"], vocab)


def sample(seed: int, n_total: int, n: int, must: list[int]) -> list[int]:
    """``n`` indices of ``n_total`` drawn from the seed, with ``must`` in."""
    r = rng(seed, 3)
    pick = list(dict.fromkeys(list(must) + [int(i) for i in
                                            r.permutation(n_total)]))
    return sorted(pick[:min(n, n_total)])
