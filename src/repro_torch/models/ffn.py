"""Feed-forward blocks: gated (SiLU-GLU) and non-gated (squared-ReLU / GELU)
— torch port of ``repro.models.ffn``."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common


def init(gen: torch.Generator, cfg: ModelConfig, dtype, device,
         d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.act == "silu_glu":
        return {
            "w_gate": common.dense_init(gen, d, f, dtype, device),
            "w_up": common.dense_init(gen, d, f, dtype, device),
            "w_down": common.dense_init(gen, f, d, dtype, device),
        }
    return {
        "w_up": common.dense_init(gen, d, f, dtype, device),
        "w_down": common.dense_init(gen, f, d, dtype, device),
    }


def apply(params, x: torch.Tensor, cfg: ModelConfig, key=None) -> torch.Tensor:
    td_in = cfg.site_tdvmm("ffn.in")
    if "w_gate" in params:
        h = common.activation("silu", common.dense(params["w_gate"], x, td_in, key))
        h = h * common.dense(params["w_up"], x, td_in, key)
    else:
        h = common.activation(cfg.act, common.dense(params["w_up"], x, td_in, key))
    return common.dense_tp_reduce(params["w_down"], h,
                                  cfg.site_tdvmm("ffn.out"), key)
