"""The plain reference: a decoder of attention + MoE layers whose expert
matmuls run as the paper's time-domain VMM, in plain PyTorch.

It imports nothing of the program.  It reads the weights the benchmark
made (``perfbench.weights``), the token ids the traffic sent, and the
configuration file's ``run`` section, and works out again everything the
program derives from them: the routing, the 6-bit input and weight codes,
the exact integer charge sums, the readout windows of the one calibration
pass, and the readout.

The model, per layer (pre-norm, residual):
    h = x + Wo · attn(RoPE(Wq n1(x)), RoPE(Wk n1(x)), Wv n1(x))   causal, GQA
    y = h + sum_k g_k E_k(n2(h)) + sum_s S_s(n2(h))
    E(x) = down(silu(gate(x)) * up(x)); the router softmax(x Wr), top-k by
    probability (the lower index first among equals), gates renormalised;
    every routed token reaches its experts (dropless).
then the logits n_f(x) · W_head.  n(x) = x / sqrt(mean(x^2) + eps) * scale.
RoPE rotates the two halves of each head (theta from the file).

A TD-VMM site (the file's plan pattern) on x (R, K) and w (K, N), p bits,
L = 2^p - 1 (paper Eq. 2-3, section 3.1):
    x codes: round(clip(x / max|x_row|, -1, 1) L) per row,
    w codes: round(clip(w / max|w_col|, -1, 1) L) per column,
    acc = x codes . w codes exactly (int8 codes, int32 sums),
    z = acc / (L L 2K), the readout q = round(clip(z / s, -1, 1) L) over
    the window s, y = q s / L * max|x_row| * max|w_col| * 2K.
The window of an expert is the largest |z| that the calibration pass saw
at that site (gate and up share ``.in``; the layers share a site); during
that pass each call reads out over its own largest |z|.

It computes at the precision the configuration states: weights and every
activation between two operations held in the configuration's dtype
(bfloat16), every sum, norm and softmax in float32, TF32 off.  (A float32
reference cannot tell the program from the control: the 6-bit codes turn
each bfloat16 rounding of an activation near a code boundary into a whole
code step.)  With ``precision="fp8"`` it is the control, computed in the
step below bfloat16: every activation the configuration holds in bfloat16,
and every matmul operand (weights, queries, keys, values, probabilities),
held in float8 e4m3 with a per-tensor scale.
"""
from __future__ import annotations

import fnmatch
from typing import Optional

import torch

FP8_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    t = t.to(torch.float32)
    s = torch.clamp_min(t.abs().amax(), 1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _exact_dot(xc: torch.Tensor, wc: torch.Tensor,
               levels: int) -> torch.Tensor:
    """Integer codes (R, K) . (K, N) of |code| <= ``levels``, exactly: as
    int8 with int32 sums (``torch._int_mm``; |sum| <= 127^2 K < 2^31),
    zero-padded to its shape rules (zero codes add nothing), or in float64
    for codes past int8."""
    if levels > 127 or xc.numel() == 0:
        return xc.to(torch.float64) @ wc.to(torch.float64)
    r, k = xc.shape
    n = wc.shape[1]
    up = lambda v, m: -(-v // m) * m                                # noqa: E731
    a = torch.nn.functional.pad(xc.to(torch.int8),
                                (0, up(k, 8) - k, 0, max(17, up(r, 8)) - r))
    b = torch.nn.functional.pad(wc.to(torch.int8),
                                (0, up(n, 8) - n, 0, up(k, 8) - k))
    return torch._int_mm(a, b.contiguous())[:r, :n]


class Reference:
    """One configuration's reference over the benchmark's weights."""

    def __init__(self, params: dict, run: dict, precision: str = "stated",
                 codes: Optional[dict] = None):
        """``codes``: a dict the programmed weight codes are kept in, by
        weight; references of one set of weights may share it."""
        if precision not in ("stated", "fp8"):
            raise ValueError(f"precision {precision!r}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.p = params
        self.run = run
        self.fp8 = precision == "fp8"
        self.store = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                      "float32": torch.float32}[run["dtype"]]
        self.levels = (1 << run["bits"]) - 1
        self.windows: dict[str, torch.Tensor] = {}
        self.codes = {} if codes is None else codes

    # -- helpers ----------------------------------------------------------
    def _r(self, t: torch.Tensor) -> torch.Tensor:
        """An activation as this precision holds it: the configuration's
        dtype (float32 tensors carrying its values), or float8."""
        if self.fp8:
            return _fp8(t)
        return t.to(self.store).to(torch.float32)

    def _q(self, t: torch.Tensor) -> torch.Tensor:
        """A matmul operand as this precision holds it."""
        return _fp8(t) if self.fp8 else t.to(torch.float32)

    def _mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """A matmul: float32 sums, the output held in the dtype."""
        return self._r(self._q(a) @ self._q(w))

    def _td(self, site: str) -> bool:
        return fnmatch.fnmatchcase(site, self.run["tdvmm"])

    def _norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return self._r(x * torch.rsqrt(var + self.run["norm_eps"])
                       * scale.to(torch.float32))

    def _rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        hd = x.shape[-1]
        inv = 1.0 / (self.run["rope_theta"] ** (
            torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
        ang = pos.to(torch.float32)[:, None] * inv[None]          # (S, hd/2)
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
        return self._r(torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                                 -1))

    # -- the time-domain VMM ---------------------------------------------
    def _codes(self, t: torch.Tensor, dim: int):
        m = torch.clamp_min(t.abs().amax(dim=dim, keepdim=True), 1e-6)
        n = t / m
        c = torch.sign(n) * torch.round(torch.clamp(n.abs(), 0.0, 1.0)
                                        * self.levels)
        return c, m

    def _weight_codes(self, w: torch.Tensor):
        """A weight's programmed codes (int8) and column scales, once."""
        key = (w.data_ptr(), tuple(w.shape))
        if key not in self.codes:
            c, m = self._codes(w.to(torch.float32), -2)
            self.codes[key] = (c.to(torch.int8) if self.levels <= 127 else c,
                               m)
        return self.codes[key]

    def td_matmul(self, x: torch.Tensor, w: torch.Tensor,
                  window: Optional[float]) -> tuple[torch.Tensor, float]:
        """(y, largest |z|) of one TD-VMM tile; ``window`` None reads out
        over this call's own largest |z| (the calibration pass)."""
        k = x.shape[-1]
        xc, xs = self._codes(self._q(x), -1)
        wc, ws = self._weight_codes(w)
        acc = _exact_dot(xc, wc, self.levels).to(torch.float32)
        L = self.levels
        gain = float(torch.tensor(1.0 / (L * L * 2.0 * k),
                                  dtype=torch.float32))
        z = acc * gain
        zmax = float(z.abs().amax()) if z.numel() else 0.0
        s = max(zmax, 1e-9) if window is None else window
        s32 = torch.tensor(s, dtype=torch.float32, device=x.device)
        q = torch.round(torch.clamp(z * (1.0 / s32), -1.0, 1.0) * L)
        y = (q * xs) * (ws * float(torch.tensor(2.0 * k,
                                                dtype=torch.float32))
                        * (s32 * float(torch.tensor(1.0 / L,
                                                    dtype=torch.float32))))
        return y, zmax

    def _site(self, site: str, x: torch.Tensor, w: torch.Tensor,
              slot: int, record: Optional[dict]) -> torch.Tensor:
        if not self._td(site):
            return self._mm(x, w)
        window = None if record is not None else \
            float(self.windows[site][slot])
        y, zmax = self.td_matmul(x, w, window)
        y = self._r(y)
        if record is not None:
            prev = record.setdefault(site, {})
            prev[slot] = max(prev.get(slot, 0.0), zmax)
        return y

    # -- layers -----------------------------------------------------------
    def _attention(self, lp: dict, h: torch.Tensor) -> torch.Tensor:
        """One sequence h (S, d), causal."""
        r = self.run
        s, hd = h.shape[0], r["head_dim"]
        nh, kv = r["n_heads"], r["n_kv_heads"]
        pos = torch.arange(s, device=h.device)
        q = self._mm(h, lp["wq"]["w"]).reshape(s, nh, hd)
        k = self._mm(h, lp["wk"]["w"]).reshape(s, kv, hd)
        v = self._mm(h, lp["wv"]["w"]).reshape(s, kv, hd)
        q, k = self._rope(q, pos), self._rope(k, pos)
        q = self._q(q).reshape(s, kv, nh // kv, hd)
        k, v = self._q(k), self._q(v)
        sc = self._r(torch.einsum("skgd,tkd->kgst", q, k)) \
            * float(torch.tensor(hd ** -0.5, dtype=torch.float32))
        mask = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
        sc = sc.masked_fill(~mask, float("-inf"))
        pr = self._q(self._r(torch.softmax(sc, dim=-1)))
        out = self._r(torch.einsum("kgst,tkd->skgd", pr, v)).reshape(
            s, nh * hd)
        return self._mm(out, lp["wo"]["w"])

    def _ffn(self, bank: dict, e: int, x: torch.Tensor, prefix: str,
             record: Optional[dict]) -> torch.Tensor:
        g = self._site(prefix + ".in", x, bank["w_gate"][e], e, record)
        u = self._site(prefix + ".in", x, bank["w_up"][e], e, record)
        hmid = self._r(self._r(torch.nn.functional.silu(g)) * u)
        return self._site(prefix + ".out", hmid, bank["w_down"][e], e,
                          record)

    def _moe(self, mp: dict, x: torch.Tensor,
             record: Optional[dict]) -> torch.Tensor:
        """x (T, d): every token of the call, routed together."""
        r = self.run
        logits = self._mm(x, mp["router"]["w"])
        probs = torch.softmax(logits, dim=-1)
        gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, ids = gates[:, :r["top_k"]], ids[:, :r["top_k"]]
        gates = self._r(gates / torch.clamp_min(gates.sum(-1, keepdim=True),
                                                1e-9))
        y = torch.zeros_like(x)
        for e in torch.unique(ids).tolist():
            rows, slot = torch.nonzero(ids == e, as_tuple=True)
            o = self._ffn(mp["experts"], e, x[rows], "moe.expert", record)
            y.index_add_(0, rows, self._r(o * gates[rows, slot][:, None]))
        y = self._r(y)
        for s in range(r["n_shared_experts"]):
            y = self._r(y + self._ffn(mp["shared"], s, x, "moe.shared",
                                      record))
        return y

    def hidden(self, seqs: list[torch.Tensor],
               record: Optional[dict] = None) -> list[torch.Tensor]:
        """The final normed hidden states (S_i, d) of each token sequence;
        the MoE of each layer sees every token of every sequence in one
        call (as a batched step routes them)."""
        xs = [self.p["embed"]["table"][t.long()].to(torch.float32)
              for t in seqs]
        lens = [x.shape[0] for x in xs]
        for lp in self.p["blocks"]["seg0"]:
            xs = [self._r(x + self._attention(lp["attn"], self._norm(
                x, lp["ln1"]["scale"]))) for x in xs]
            flat = torch.cat(xs)
            flat = self._r(flat + self._moe(lp["moe"], self._norm(
                flat, lp["ln2"]["scale"]), record))
            xs = list(torch.split(flat, lens))
        return [self._norm(x, self.p["ln_f"]["scale"]) for x in xs]

    def logits(self, h: torch.Tensor, vocab: int,
               cols: int = 32768) -> torch.Tensor:
        """(R, vocab) float32 logits of hidden rows h (R, d)."""
        w = self.p["head"]["w"]
        if self._td("head"):
            raise NotImplementedError("a TD-VMM head is not in any plan")
        return torch.cat([self._mm(h, w[:, lo:min(lo + cols, vocab)])
                          for lo in range(0, vocab, cols)], dim=-1)

    # -- calibration ------------------------------------------------------
    def calibrate(self, batch: torch.Tensor) -> None:
        """The one calibration pass over ``batch`` (B, S): every TD-VMM site
        records its largest |z| per expert; unrouted experts keep 1e-9."""
        rec: dict = {}
        self.hidden(list(batch), record=rec)
        r = self.run
        n_slots = {"moe.expert": r["n_experts"],
                   "moe.shared": r["n_shared_experts"]}
        self.windows = {}
        for site, slots in rec.items():
            n = n_slots[site.rsplit(".", 1)[0]]
            w = torch.full((n,), 1e-9, dtype=torch.float64)
            for e, v in slots.items():
                w[e] = max(v, 1e-9)
            self.windows[site] = w.to(torch.float32)
