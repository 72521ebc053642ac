"""Longer QAT training curves on the card.

    python3 scripts/train_curves.py [--out chiprun_out/train_curves.json]

Every curve runs ``launch/train.train_loop`` from random weights with every
linear a 6-bit TD-VMM site (QAT), on SyntheticLM tokens (Zipf 1.3: the
unigram entropy, the floor a context-free model can reach, is 4.40 nats at
a vocabulary of 32,000 and 4.59 at 151,936):

- mixtral-8x7b at full width, 2 of its 32 layers, as ``chip_smoke.py``'s
  "train mixtral" (``chip_smoke.train_mixtral``: the dropless capacity
  factor, AdamW with bfloat16 moments, one warmup step, 4 x 512 tokens a
  step), ``MIX_STEPS`` steps at lr 1e-4 and at 3e-5 from seed 0, and at
  1e-4 from seed 1 (other weights and other batches);
- qwen1.5-0.5b at full width and depth, as "train" (AdamW at lr 1e-3, two
  warmup steps, 4 x 512 tokens a step), ``QWEN_STEPS`` steps.

Each curve's final checkpoint goes to a temporary directory, removed after.
Prints one line per curve (losses, gradient norms, learning rates, seconds a
step, peak allocated memory; mixtral's load-balance and z losses too) and
the card's name and power limit; ``--out`` keeps the same as JSON.  A curve
is reported whatever its shape: the script fails only on a non-finite
metric or a missing step.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

MIX_STEPS, QWEN_STEPS = 24, 32
# (name, model, learning rate, seed)
CURVES = (("mixtral lr 1e-4 seed 0", "mixtral", 1e-4, 0),
          ("mixtral lr 3e-5 seed 0", "mixtral", 3e-5, 0),
          ("mixtral lr 1e-4 seed 1", "mixtral", 1e-4, 1),
          ("qwen lr 1e-3 seed 0", "qwen", 1e-3, 0))


def setup(model: str, lr: float):
    """(config, batch, seq, steps, optimizer) of one curve, as the
    chip_smoke phase it extends."""
    import chip_smoke as cs
    from repro_torch.configs import OptimizerConfig
    from repro_torch.core.layers import TDVMMLayerConfig
    from repro_torch.launch import dryrun

    if model == "mixtral":
        cfg = cs.moe_config().replace(
            n_layers=cs.MIX_TRAIN_LAYERS, remat_policy="minimal",
            tdvmm=TDVMMLayerConfig(enabled=True, bits=6, weight_bits=6))
        opt = dataclasses.replace(
            dryrun.optimizer_for(cfg), moment_dtype=cs.MIX_MOMENTS, lr=lr,
            warmup_steps=1, total_steps=MIX_STEPS)
        return cfg, cs.MOE_BATCH, cs.MOE_PROMPT, MIX_STEPS, opt
    opt = OptimizerConfig(lr=lr, warmup_steps=2, total_steps=QWEN_STEPS)
    return cs.qat_config(), cs.QAT_BATCH, cs.QAT_SEQ, QWEN_STEPS, opt


def curve(model: str, lr: float, seed: int, dev) -> dict:
    import torch
    from repro_torch.configs import RunConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import train

    cfg, batch, seq, steps, opt = setup(model, lr)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as workdir:
        run = RunConfig(model=cfg, shape=ShapeConfig(
            model, seq, batch, "train", microbatch_per_shard=batch),
            seed=seed, optimizer=opt, checkpoint_dir=workdir,
            checkpoint_every=10 * steps)
        t0 = time.perf_counter()
        out = train.train_loop(run, steps, log_every=1, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    del out["state"]
    torch.cuda.empty_cache()
    hist = out["history"]
    if len(hist) != steps or not all(
            math.isfinite(v) for h in hist for v in h.values()):
        raise RuntimeError(f"{model} lr {lr} seed {seed}: {hist}")
    keys = ("loss", "grad_norm", "lr", "dt") + (
        ("lb_loss", "z_loss") if model == "mixtral" else ())
    return dict(model=model, base_lr=lr, seed=seed, layers=cfg.n_layers,
                batch=batch, seq=seq, optimizer=opt.name,
                moments=opt.moment_dtype, seconds=seconds, peak_gb=peak / 1e9,
                **{k: [h[k] for h in hist] for k in keys})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="write the curves here as JSON")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("train_curves: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    curves = {}
    for name, model, lr, seed in CURVES:
        c = curves[name] = curve(model, lr, seed, dev)
        first = c["loss"][0]
        over = [i for i, v in enumerate(c["loss"]) if v > first]
        print(f"[curve] {name}: {c['layers']} layers, {c['batch']} x "
              f"{c['seq']} tokens, {c['optimizer']} ({c['moments']} "
              f"moments); loss " + " ".join(f"{v:.4f}" for v in c["loss"])
              + "; gnorm " + " ".join(f"{v:.3f}" for v in c["grad_norm"])
              + "; lr " + " ".join(f"{v:.3g}" for v in c["lr"])
              + (("; lb_loss " + " ".join(f"{v:.4f}" for v in c["lb_loss"])
                  + "; z_loss " + " ".join(f"{v:.4f}" for v in c["z_loss"]))
                 if "lb_loss" in c else "")
              + "; step s " + " ".join(f"{v:.3f}" for v in c["dt"])
              + f"; steps above the first loss: {over or 'none'}; min "
              f"{min(c['loss']):.4f} at step {c['loss'].index(min(c['loss']))}"
              f"; {c['seconds']:.1f} s with the checkpoint; peak allocated "
              f"{c['peak_gb']:.2f} GB | {card}", flush=True)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(dict(card=card, curves=curves),
                                           indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
