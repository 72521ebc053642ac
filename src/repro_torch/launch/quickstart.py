"""Quickstart: the time-domain VMM in six steps, on the card (the port's
counterpart of ``examples/quickstart.py``):

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu] \\
        [--seed 0]

1. encode a vector as turn-on times,
2. program a weight matrix into current sources (Eq. 5-7),
3. integrate charge + fire latches (the event-driven simulation; kernel B4
   on the card),
4. decode crossing times -> exact normalized dot products (Eq. 1),
5. drop the same multiplier into a model as a quantized linear layer (kernel
   B2 on the card), and chain two layers in the time domain (Fig. 2),
6. address a whole LM's analog matmuls with a site plan + calibration (B1
   raw and B2 in calibration, B1 fused in the prefill on the card).

It prints the JAX example's lines.  The example's plan routes every site
through the JAX package's ``backend="jnp"``; here that rule keeps the name
on the CPU (the plain path) and becomes ``backend="auto"`` on the card, the
kernels, so its site table names the route that runs.  The weights, the
layer's input, the second layer and the model's parameters and prompt are
drawn from a CPU ``torch.Generator`` seeded with ``--seed``; ``run`` takes
them as arguments instead (a test passes the JAX example's own draws).
Without a card it raises unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TDVMMPlan, tdvmm_rule
from repro_torch.core import currents, encoding, tdcore
from repro_torch.core.constants import TDVMMSpec
from repro_torch.core.layers import TDVMMLayerConfig, td_matmul
from repro_torch.models import common, model

SPEC = TDVMMSpec(bits=6)
X = (0.8, -0.3, 0.5, 0.0, -1.0, 0.25, 0.9, -0.6)
LAYER_CFG = TDVMMLayerConfig(enabled=True, bits=6, weight_bits=6)
PROMPT = (2, 16)
MAX_LEN = 24


def lm_config(device) -> ModelConfig:
    """The example's 2-layer ``quickstart-lm`` with its four-rule plan: every
    site a 6-bit tile, cheaper attention projections, ffn.in chained into
    ffn.out, a more precise head."""
    backend = "jnp" if torch.device(device).type == "cpu" else "auto"
    return ModelConfig(
        name="quickstart-lm", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
        vocab_pad_multiple=16, dtype="float32", remat_policy="none",
        tdvmm_plan=TDVMMPlan(rules=(
            tdvmm_rule("*", enabled=True, backend=backend),
            tdvmm_rule("attn.qkv", bits=5),
            tdvmm_rule("ffn.in", chain=True),
            tdvmm_rule("head", bits=7),
        )))


def draws(seed: int, lm: ModelConfig, device) -> dict:
    """The random inputs of the six steps, from a CPU generator: the (8, 4)
    and (4, 3) weights U(-1, 1), the layer's (4, 8) normal input, the
    model's parameters and its (2, 16) prompt."""
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.rand((8, 4), generator=g) * 2.0 - 1.0,
            "xb": torch.randn((4, 8), generator=g),
            "w2": torch.rand((4, 3), generator=g) * 2.0 - 1.0,
            "tokens": torch.randint(0, lm.vocab_size, PROMPT, generator=g),
            "params": model.init_params(seed, lm, device=device)}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def run(device=None, seed: int = 0, w=None, xb=None, w2=None, params=None,
        tokens=None) -> dict:
    """The six steps on ``device`` (the card unless given); the random
    inputs default to ``draws(seed)``.  Prints the JAX example's lines and
    returns every intermediate result as a CPU tensor."""
    device = common.resolve_device(device)
    lm = lm_config(device)
    given = dict(w=w, xb=xb, w2=w2, params=params, tokens=tokens)
    if any(v is None for v in given.values()):
        drawn = draws(seed, lm, device)
        given = {k: drawn[k] if v is None else v for k, v in given.items()}
    w, xb, w2 = (torch.as_tensor(given[k], dtype=torch.float32).to(device)
                 for k in ("w", "xb", "w2"))
    spec, out = SPEC, {}
    print(f"operating point: p={spec.bits} bits, "
          f"T={spec.t_window_s * 1e9:.0f} ns, I_max={spec.i_max * 1e6:.1f} "
          f"uA, period={spec.latency_s * 1e9:.0f} ns")

    # -- 1. time-encode an input vector --------------------------------------
    x = torch.tensor(X, dtype=torch.float32, device=device)
    x_pos, _ = encoding.four_quadrant_split(x)
    t_on = encoding.value_to_onset(x_pos, spec.t_window_s)
    print("\ninputs       :", _np(x))
    print("onset times + wire (ns):", _np(t_on * 1e9).round(1))

    # -- 2. program a signed weight matrix into four current-source arrays ---
    prog = currents.four_quadrant_program(w, spec.i_max, spec.w_max)
    print("\ncurrents (uA), + wire, col 0:",
          _np(prog["pos"][:, 0] * 1e6).round(3))
    print("bias current (uA), + wire   :",
          _np(prog["bias_pos"] * 1e6).round(3))

    # -- 3+4. event-driven crossing simulation vs the closed form ------------
    y_sim, (t_plus, t_minus) = tdcore.td_vmm_four_quadrant(
        x, w, spec, return_times=True)
    y_ref = tdcore.ideal_four_quadrant(x, w, spec.w_max)
    print("\nlatch fire times + wire (ns):", _np(t_plus * 1e9).round(2))
    print("decoded outputs :", _np(y_sim))
    print("closed form Eq.1:", _np(y_ref))
    print("max |err|       :", float((y_sim - y_ref).abs().max()))

    # -- 5. the same multiplier as a model layer (QAT's forward) -------------
    y_layer = td_matmul(xb, w, LAYER_CFG)
    exact = xb @ w
    print("\nTD-VMM layer out (6-bit):", _np(y_layer[0]))
    print("exact matmul            :", _np(exact[0]))
    # chaining: a 2-layer MLP entirely in the time domain (Fig. 2)
    y_mlp = tdcore.td_mlp_forward(x, w, w2, spec)
    ideal = tdcore.ideal_mlp(x, w, w2, spec.w_max)
    print("\n2-layer time-domain MLP out:", _np(y_mlp), "\n(ideal:",
          _np(ideal), ")")

    # -- 6. site plans: per-site configs + model-wide calibration ------------
    described = lm.resolved_tdvmm_plan.describe()
    print("\nresolved TD-VMM site plan:")
    print(described)
    params = given["params"]
    batch = {"inputs": torch.as_tensor(given["tokens"]).to(device)}
    calib = model.calibrate(params, batch, lm, device=device)
    print("calibrated windows:",
          {site: round(float(v.max()), 4)
           for site, v in calib.windows.items()})
    caches = model.init_caches(lm, PROMPT[0], MAX_LEN, device)
    with torch.no_grad():
        logits, caches = model.prefill_step(params, batch, caches, lm,
                                            calib=calib)
    print("calibrated prefill logits:", tuple(logits.shape))
    out.update(x=x, t_on=t_on, prog=prog, y_sim=y_sim, t_plus=t_plus,
               t_minus=t_minus, y_ref=y_ref, y_layer=y_layer, exact=exact,
               y_mlp=y_mlp, ideal_mlp=ideal, logits=logits)
    out = {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict)
               else v.detach().cpu()) for k, v in out.items()}
    out.update(describe=described, windows=calib.windows)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain torch path; default: the card")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    return run(args.device, args.seed)


if __name__ == "__main__":
    main()
