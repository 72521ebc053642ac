"""The 10 assigned architectures, exact configs from the public literature.

Every entry is selectable via ``--arch <id>`` in the launchers.  Sources are
noted per config (see task assignment).  ``smoke(cfg)`` derives the reduced
same-family variant used by per-arch CPU smoke tests.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig


def yi_34b() -> ModelConfig:
    # [arXiv:2403.04652] llama-arch GQA
    return ModelConfig(
        name="yi-34b", family="dense", n_layers=60, d_model=7168, n_heads=56,
        n_kv_heads=8, head_dim=128, d_ff=20480, vocab_size=64000,
        act="silu_glu", rope_theta=5_000_000.0)


def qwen2_5_14b() -> ModelConfig:
    # [hf:Qwen/Qwen2.5-*] GQA with QKV bias
    return ModelConfig(
        name="qwen2.5-14b", family="dense", n_layers=48, d_model=5120, n_heads=40,
        n_kv_heads=8, head_dim=128, d_ff=13824, vocab_size=152064,
        act="silu_glu", qkv_bias=True, rope_theta=1_000_000.0)


def qwen1_5_0_5b() -> ModelConfig:
    # [hf:Qwen/Qwen1.5-0.5B] MHA (kv=16), QKV bias
    return ModelConfig(
        name="qwen1.5-0.5b", family="dense", n_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=16, head_dim=64, d_ff=2816, vocab_size=151936,
        act="silu_glu", qkv_bias=True, tie_embeddings=True)


def nemotron_4_15b() -> ModelConfig:
    # [arXiv:2402.16819] GQA, squared-ReLU (non-gated) FFN
    return ModelConfig(
        name="nemotron-4-15b", family="dense", n_layers=32, d_model=6144, n_heads=48,
        n_kv_heads=8, head_dim=128, d_ff=24576, vocab_size=256000, act="sq_relu")


def llava_next_mistral_7b() -> ModelConfig:
    # [hf:llava-hf/llava-v1.6-mistral-7b-hf] Mistral-7B backbone (SWA 4096);
    # anyres vision tiling is the stubbed frontend: inputs are patch embeddings.
    return ModelConfig(
        name="llava-next-mistral-7b", family="vlm", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=32000,
        act="silu_glu", swa_window=4096, input_mode="embeddings")


def musicgen_large() -> ModelConfig:
    # [arXiv:2306.05284] decoder-only over EnCodec tokens; frame-embedding stub.
    return ModelConfig(
        name="musicgen-large", family="audio", n_layers=48, d_model=2048,
        n_heads=32, n_kv_heads=32, head_dim=64, d_ff=8192, vocab_size=2048,
        act="gelu", input_mode="embeddings")


def mamba2_1_3b() -> ModelConfig:
    # [arXiv:2405.21060] SSD, attention-free
    return ModelConfig(
        name="mamba2-1.3b", family="ssm", n_layers=48, d_model=2048, n_heads=1,
        n_kv_heads=1, d_ff=0, vocab_size=50280,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=128))


def mixtral_8x7b() -> ModelConfig:
    # [arXiv:2401.04088] 8 experts top-2, SWA
    return ModelConfig(
        name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=32000,
        act="silu_glu", swa_window=4096,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=14336, impl="local"))


def kimi_k2_1t_a32b() -> ModelConfig:
    # [arXiv:2501.kimi2, paper table] trillion-param MoE: 384 experts top-8
    # (+1 shared), GQA kv=8.  head_dim = 7168/64 = 112.
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
        n_heads=64, n_kv_heads=8, head_dim=112, d_ff=2048, vocab_size=163840,
        act="silu_glu",
        moe=MoEConfig(n_experts=384, top_k=8, d_ff=2048, n_shared_experts=1,
                      impl="ep"))


def zamba2_2_7b() -> ModelConfig:
    # [arXiv:2411.15242] Mamba2 backbone + shared attention block (with the
    # concat-embedding fuse), every 6 SSM layers.
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560, n_heads=32,
        n_kv_heads=32, head_dim=80, d_ff=10240, vocab_size=32000, act="silu_glu",
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
        hybrid_attn_every=6, hybrid_concat_embed=True)


ARCHS = {
    "yi-34b": yi_34b,
    "qwen2.5-14b": qwen2_5_14b,
    "qwen1.5-0.5b": qwen1_5_0_5b,
    "nemotron-4-15b": nemotron_4_15b,
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "musicgen-large": musicgen_large,
    "mamba2-1.3b": mamba2_1_3b,
    "mixtral-8x7b": mixtral_8x7b,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b,
    "zamba2-2.7b": zamba2_2_7b,
}


def get_config(name: str, **overrides) -> ModelConfig:
    cfg = ARCHS[name]()
    return cfg.replace(**overrides) if overrides else cfg


def smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (small dims, few layers)."""
    kw = dict(
        n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16, d_ff=128, vocab_size=512, vocab_pad_multiple=16,
        dtype="float32", remat_policy="none",
    )
    if cfg.swa_window is not None:
        kw["swa_window"] = 8
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2, d_ff=32,
            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
            first_k_dense=min(cfg.moe.first_k_dense, 1))
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, expand=2, chunk=8)
    if cfg.family == "hybrid":
        kw["n_layers"] = 4
        kw["hybrid_attn_every"] = 2
    return cfg.replace(**kw)
