"""End-to-end LM training (the port's counterpart of
``examples/train_lm.py``): a qwen-family model of one of the example's
profiles, TD-VMM quantized linears (6-bit QAT) on by default, through
``launch/train.train_loop``.

    PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu \\
        --steps 20                                     # quick profile, CPU
    PYTHONPATH=src python -m repro_torch.launch.train_lm --profile 100m

Without ``--device`` it runs on the card and raises when there is none.  It
auto-resumes from ``--ckpt-dir``: remove the directory to start over.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import OptimizerConfig, RunConfig, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.layers import TDVMMLayerConfig
from repro_torch.launch.train import train_loop

PROFILES = {
    # (d_model, n_layers, n_heads, kv, d_ff, seq, batch, steps)
    "quick": (256, 4, 4, 2, 1024, 256, 8, 300),
    "20m": (384, 6, 6, 2, 1536, 512, 8, 300),
    "100m": (768, 12, 12, 4, 3072, 1024, 16, 300),
}


def run_config(profile: str, steps: int | None, tdvmm: bool,
               ckpt_dir: str) -> tuple[RunConfig, int]:
    d, n_layers, h, kv, ff, seq, batch, default_steps = PROFILES[profile]
    steps = steps or default_steps
    cfg = get_config("qwen1.5-0.5b").replace(
        d_model=d, n_layers=n_layers, n_heads=h, n_kv_heads=kv,
        head_dim=d // h, d_ff=ff, vocab_size=8192, vocab_pad_multiple=16,
        dtype="float32", remat_policy="none",
        tdvmm=TDVMMLayerConfig(enabled=tdvmm, bits=6, weight_bits=6))
    shape = ShapeConfig("example", seq_len=seq, global_batch=batch,
                        kind="train", microbatch_per_shard=batch)
    run = RunConfig(model=cfg, shape=shape,
                    optimizer=OptimizerConfig(lr=1e-3, warmup_steps=30,
                                              total_steps=steps),
                    checkpoint_dir=ckpt_dir, checkpoint_every=100)
    return run, steps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", default="quick", choices=sorted(PROFILES))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--tdvmm", action="store_true", default=True)
    ap.add_argument("--no-tdvmm", dest="tdvmm", action="store_false")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain torch path; default: the card")
    args = ap.parse_args(argv)
    run, steps = run_config(args.profile, args.steps, args.tdvmm,
                            args.ckpt_dir)
    print(f"[config] {run.model.param_count() / 1e6:.1f}M params, "
          f"tdvmm={'6-bit' if args.tdvmm else 'off'}")
    out = train_loop(run, steps, log_every=20, device=args.device)
    if not out["history"]:
        raise RuntimeError(f"nothing trained: {args.ckpt_dir} already holds "
                           f"step {out['step']}; remove it to start over")
    first, last = out["history"][0]["loss"], out["history"][-1]["loss"]
    print(f"[done] loss {first:.3f} -> {last:.3f} over {out['step']} steps "
          f"({out.get('total_s', 0):.0f}s, "
          f"stragglers={out.get('stragglers')})")
    if last >= first:
        raise RuntimeError(f"loss did not decrease: {first:.3f} -> "
                           f"{last:.3f}")
    return out


if __name__ == "__main__":
    main()
