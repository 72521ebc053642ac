"""Weights made by the benchmark from ``--seed``, on the device, in the
dtype they are served in, one large ``torch.Generator`` call per tensor.
Both the program and the reference read these same tensors; the layout is
the one the program's model functions take (``repro_torch.models.model``):

    {"embed": {"table": (V, d)},
     "blocks": {"seg0": [{"ln1", "ln2": {"scale": (d,)},
                          "attn": {"wq", "wk", "wv", "wo": {"w"}},
                          "moe": {"router": {"w": (d, E) float32},
                                  "experts": {"w_gate", "w_up": (E, d, f),
                                              "w_down": (E, f, d)},
                                  "shared": {same, n_shared}}}, ...]},
     "ln_f": {"scale": (d,)}, "head": {"w": (d, V)}}

Norm scales are drawn around 1, so that a norm that drops its scale shows.
"""
from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def make(run: dict, seed: int, device, vocab_rows: int) -> dict:
    """The weights of the configuration ``run`` (its file's ``run`` section)
    for ``seed``; the embedding and head hold ``vocab_rows`` rows (the
    vocabulary padded as the program pads it)."""
    dtype = DTYPES[run["dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2**63 - 1))
    d, hd = run["d_model"], run["head_dim"]
    h, kv, f = run["n_heads"], run["n_kv_heads"], run["expert_d_ff"]
    e, s = run["n_experts"], run["n_shared_experts"]

    def normal(shape, scale, dt=dtype):
        return torch.randn(shape, generator=gen, dtype=dt,
                           device=device).mul_(scale)

    def norm():
        return {"scale": normal((d,), 0.05).add_(1.0)}

    def bank(n):
        return {"w_gate": normal((n, d, f), d ** -0.5),
                "w_up": normal((n, d, f), d ** -0.5),
                "w_down": normal((n, f, d), f ** -0.5)}

    layers = []
    for _ in range(run["n_layers"]):
        moe = {"router": {"w": normal((d, e), d ** -0.5, torch.float32)},
               "experts": bank(e)}
        if s:
            moe["shared"] = bank(s)
        layers.append({
            "ln1": norm(), "ln2": norm(),
            "attn": {"wq": {"w": normal((d, h * hd), d ** -0.5)},
                     "wk": {"w": normal((d, kv * hd), d ** -0.5)},
                     "wv": {"w": normal((d, kv * hd), d ** -0.5)},
                     "wo": {"w": normal((h * hd, d), (h * hd) ** -0.5)}},
            "moe": moe})
    return {"embed": {"table": normal((vocab_rows, d), 1.0)},
            "blocks": {"seg0": layers},
            "ln_f": norm(),
            "head": {"w": normal((d, vocab_rows), d ** -0.5)}}
