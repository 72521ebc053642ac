"""The work a step needs, counted from the configuration's widths and the
tokens the traffic sends, never from what the program launched: model
FLOPs (for ``step_mfu``) and the least time of the TD-VMM matmuls (for
``tdvmm_roofline``).

A step is described by three counts: the tokens that pass through every
layer, the sum over those tokens of the keys each attends to (causal), and
the rows whose logits the head computes.  Padding is never counted: a
prefill chunk counts its valid tokens, a decode step its active rows, and
an expert its routed rows, not its capacity buffer.

TD-VMM sites (those the configuration's plan pattern matches) count at the
int8 peak; every other FLOP at the configuration's dtype peak.  A TD-VMM
launch's least time is the larger of its operations over the int8 peak and
its bytes over HBM bandwidth.  Its bytes are the int8 input codes of the
routed rows, the int8 weight codes of the experts that got tokens (with
uniform routing of T tokens to k of E experts, E (1 - (1 - k/E)^T) of
them), float32 outputs, and the per-row and per-column scales.
"""
from __future__ import annotations

import dataclasses
import fnmatch

@dataclasses.dataclass(frozen=True)
class Shape:
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab_size: int
    n_experts: int
    top_k: int
    expert_d_ff: int
    n_shared_experts: int
    tdvmm: str
    dtype: str

    @classmethod
    def from_run(cls, run: dict) -> "Shape":
        return cls(**{f.name: run[f.name] for f in dataclasses.fields(cls)})

    def td(self, site: str) -> bool:
        return fnmatch.fnmatchcase(site, self.tdvmm)


def experts_hit(tokens: int, top_k: int, n_experts: int) -> float:
    """Expected experts that get at least one of ``tokens`` tokens, each
    routed to ``top_k`` distinct experts of ``n_experts`` uniformly."""
    if tokens <= 0:
        return 0.0
    return n_experts * (1.0 - (1.0 - top_k / n_experts) ** tokens)


@dataclasses.dataclass
class Tally:
    """Work summed over the steps of a window."""
    td_ops: float = 0.0          # operations at TD-VMM sites (int8 peak)
    other_flops: float = 0.0     # every other model FLOP (dtype peak)
    td_least_s: float = 0.0      # sum of TD-VMM launches' least times
    tokens: int = 0

    def add(self, other: "Tally") -> None:
        self.td_ops += other.td_ops
        self.other_flops += other.other_flops
        self.td_least_s += other.td_least_s
        self.tokens += other.tokens

    def least_s(self, peaks: dict, dtype: str) -> float:
        """The least time of the model FLOPs: TD-VMM operations at the int8
        peak, the rest at the dtype's."""
        return self.td_ops / peaks["int8"] + self.other_flops / peaks[dtype]


def _launch(rows: float, k: int, n: int, banks: float, peaks: dict
            ) -> tuple[float, float]:
    """(operations, least seconds) of one TD-VMM launch."""
    ops = 2.0 * rows * k * n
    nbytes = rows * k + banks * k * n + rows * n * 4 + rows * 4 + banks * n * 4
    return ops, max(ops / peaks["int8"], nbytes / peaks["hbm_bytes_s"])


def step(sh: Shape, tokens: int, contexts: int, head_rows: int,
         peaks: dict) -> Tally:
    """The work of one forward step over ``tokens`` tokens (each layer's
    experts launched once over all of them)."""
    t = Tally(tokens=tokens)
    if tokens <= 0:
        return t
    d, hd, h, kv = sh.d_model, sh.head_dim, sh.n_heads, sh.n_kv_heads

    def site(name: str, rows: float, k: int, n: int, banks: float,
             calls: int = 1) -> None:
        ops, least = _launch(rows, k, n, banks, peaks)
        if sh.td(name):
            t.td_ops += ops * calls
            t.td_least_s += least * calls
        else:
            t.other_flops += ops * calls

    hit = experts_hit(tokens, sh.top_k, sh.n_experts)
    for _ in range(sh.n_layers):
        site("attn.qkv", tokens, d, (h + 2 * kv) * hd, 1)
        site("attn.out", tokens, h * hd, d, 1)
        t.other_flops += 4.0 * h * hd * contexts          # QK^T and PV
        t.other_flops += 2.0 * tokens * d * sh.n_experts  # the router
        # gate and up (two launches at moe.*.in), down (one at .out)
        f, k = sh.expert_d_ff, sh.top_k
        site("moe.expert.in", tokens * k, d, f, hit, calls=2)
        site("moe.expert.out", tokens * k, f, d, hit)
        if sh.n_shared_experts:
            s = sh.n_shared_experts
            site("moe.shared.in", tokens * s, d, f, s, calls=2)
            site("moe.shared.out", tokens * s, f, d, s)
    if head_rows:
        site("head", head_rows, d, sh.vocab_size, 1)
    return t


def causal_contexts(start: int, n: int) -> int:
    """Keys attended by ``n`` tokens at positions start .. start + n - 1."""
    return n * start + n * (n + 1) // 2
