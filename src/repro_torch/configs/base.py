"""Config system: model architectures, input shapes, run settings.

TD-VMM configuration is **site-addressable**: every analog matmul in a model
has a canonical site name (``attn.qkv``, ``ffn.in``, ``moe.expert.out``,
``head``, ...) and a ``TDVMMPlan`` maps ordered glob-pattern rules onto
per-site ``TDVMMLayerConfig`` overrides.  ``ModelConfig.tdvmm`` survives as
the plan's default rule — a legacy config with only ``tdvmm`` set resolves
every site to that one config, bit-for-bit identical to the pre-plan API.
Resolution (pattern matching, chain validation, the precision report) lives
in ``repro_torch.configs.plan``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

# repro_torch.core.constants has no repro-internal imports (and repro_torch.core's
# __init__ re-exports layer objects lazily), so this does NOT recurse back
# into this module.
from repro_torch.core.constants import TDVMMSpec

def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# Frozen (hashable) singleton default: resolved site configs key caches and
# are compared by value, so every field must be hashable and two
# default configs must compare (and hash) equal.
_DEFAULT_SPEC = TDVMMSpec()


@dataclasses.dataclass(frozen=True)
class TDVMMLayerConfig:
    """Per-site TD-VMM settings (consumed by core.layers.td_matmul).

    The code-and-scale pipeline (core/quant.py) is encode -> program ->
    integrate -> readout; ``backend`` picks who runs the integrate stage:

      "auto"    kernels/tdvmm: the hand-written CUDA kernel for a tensor on
                the card, its plain torch version for a tensor on the CPU
                (default)
      "pallas"  the same as "auto" (the name the JAX package gives its
                kernel backend; plans written for it keep working)
      "jnp"     the plain torch version, chosen explicitly

    Code storage is chosen per call (core/layers.plan_matmul): codes with
    p <= 7 (incl. the default p = 6) store as int8 — quarter the HBM bytes,
    *exact* int32 accumulation for any K, so both backends are bit-for-bit
    identical with no envelope caveat.  p <= 3 on both operands packs two
    codes per byte (int4), still exact; p = 8 stores integer-valued float32
    codes, exact while worst |acc| < 2^24.  Noisy codes (``noise`` with a
    key: programming noise during training) are float32 off the integer
    grid; on the card they run in B1/B2's 3xTF32 storage.

    ``out_scale`` caches a calibration-time readout window (see
    ``TDVMMLinear.calibrate`` / ``calibrate_out_scale`` / the model-wide
    ``models.model.calibrate`` pass): serving calls skip the per-call max|z|
    reduction, and the CUDA kernel fuses the whole readout + rescale
    epilogue into its last K step.  Expert-batched sites (``moe.expert.*``) may
    carry an ``(E,)`` tuple — one calibrated window per expert tile.

    ``chain`` declares the paper's time-domain chaining: the site's output
    stays in the time domain and feeds the adjacent downstream site directly
    (Fig. 2), dropping the intermediate p-bit readout.  Plan resolution
    validates the pairing (only adjacent tile pairs like ``ffn.in`` ->
    ``ffn.out`` can chain) and rewrites the upstream site to
    ``io_quantize=False``.
    """
    enabled: bool = False
    bits: int = 6                 # time-code (input/output) precision p
    weight_bits: int = 6          # FG programming precision
    backend: str = "auto"         # integrate stage: auto | jnp | pallas
    io_quantize: bool = True      # digital tile boundary (False = time-chained)
    per_channel: bool = True      # per-output-column weight scale
    output_calibration: bool = True  # scale weights so outputs fill the [T,2T]
    # window (section 3.1: "slope ... controlled by appropriate scaling of VMM
    # weights"); modeled as a stop-grad per-tensor output gain.
    out_scale: Optional[float | tuple[float, ...]] = None  # cached calibrated
    # readout window: scalar, or per-expert (E,) tuple on expert-batched sites
    # (overrides output_calibration's per-call max; captured by calibrate())
    noise: bool = False           # stochastic DIBL + tuning noise (train-time)
    chain: bool = False           # declared time-domain chain into the
    # adjacent downstream site (plan-resolved to io_quantize=False upstream)
    site: str = ""                # canonical site name (set by plan resolution)
    spec: TDVMMSpec = _DEFAULT_SPEC

    def replace(self, **kw) -> "TDVMMLayerConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TDVMMRule:
    """One ordered plan rule: sites matching ``pattern`` (fnmatch glob over
    canonical site names) take the field ``overrides``.  Build with
    ``tdvmm_rule(pattern, **overrides)``; overrides are stored as a sorted
    tuple of pairs so rules stay hashable (cache-key safe)."""
    pattern: str
    overrides: tuple[tuple[str, Any], ...] = ()


def tdvmm_rule(pattern: str, **overrides) -> TDVMMRule:
    """``tdvmm_rule("ffn.*", bits=7, backend="jnp")`` — validated rule."""
    valid = {f.name for f in dataclasses.fields(TDVMMLayerConfig)} - {"site"}
    norm = []
    for name in sorted(overrides):
        if name not in valid:
            raise ValueError(
                f"unknown TDVMMLayerConfig field {name!r} in rule for "
                f"{pattern!r} (valid: {sorted(valid)})")
        value = overrides[name]
        if isinstance(value, (list, tuple)):
            value = tuple(float(v) for v in value)
        norm.append((name, value))
    return TDVMMRule(pattern, tuple(norm))


@dataclasses.dataclass(frozen=True)
class TDVMMPlan:
    """Site-addressable TD-VMM plan: ordered glob rules over site names.

    Resolution (``repro_torch.configs.plan.resolve_plan``) starts every site from
    ``default`` (or ``ModelConfig.tdvmm`` when ``default`` is None — the
    deprecation shim that keeps legacy single-config models working), then
    applies each matching rule's overrides in order — later rules win, so
    calibration state can be baked in as appended exact-site rules.

    A rule whose pattern matches no site in the model is legal by default
    (generic plans like ``ffn.*`` apply across families where some sites
    don't exist); resolution reports them in ``ResolvedPlan.unmatched`` /
    ``report()``, and ``strict=True`` turns them into a resolve-time error
    (catches typos like ``atn.qkv``).
    """
    rules: tuple[TDVMMRule, ...] = ()
    default: Optional[TDVMMLayerConfig] = None
    strict: bool = False

    def with_rules(self, *rules: TDVMMRule) -> "TDVMMPlan":
        return dataclasses.replace(self, rules=self.rules + tuple(rules))


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                       # per-expert hidden size
    n_shared_experts: int = 0       # always-on experts (Kimi-K2 / DeepSeek style)
    capacity_factor: float = 1.25
    first_k_dense: int = 0          # leading dense layers before MoE starts
    impl: str = "local"             # 'local' (E replicated over dp, TP inside)
    #                                 or 'ep' (experts sharded over dp, all_to_all)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128                # SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    act: str = "silu_glu"           # silu_glu | sq_relu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    swa_window: Optional[int] = None    # sliding-window attention (Mistral/Mixtral)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 0      # zamba2: shared attn block every k ssm layers
    hybrid_concat_embed: bool = False  # zamba2 concatenates embedding into shared blk
    input_mode: str = "tokens"      # tokens | embeddings (vlm/audio frontend stub)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256
    tdvmm: TDVMMLayerConfig = dataclasses.field(default_factory=TDVMMLayerConfig)
    # Site-addressable plan; None = legacy shim (every site takes ``tdvmm``).
    tdvmm_plan: Optional[TDVMMPlan] = None
    remat_policy: str = "minimal"   # none | minimal | full
    scan_layers: bool = True
    # One shard of a ``model`` axis (``launch.meshctx.local_config`` sets
    # these): the shards the config is one of, and how attention splits over
    # them: "heads" (heads and KV heads divided), "lanes" (every head kept,
    # head_dim / tp_shards lanes of each), "groups" (the shard's heads and
    # the one KV head they read, of ``tp_kv_heads``) or "whole" (kept on
    # every rank).
    tp_shards: int = 1
    attn_split: str = "heads"
    tp_kv_heads: int = 0

    def site_tdvmm(self, site: str) -> TDVMMLayerConfig:
        """Resolved TD-VMM config for one canonical site name.

        Every analog matmul call site asks for its own config here instead of
        reading the shared ``cfg.tdvmm``; with no plan set this returns
        ``tdvmm`` itself (tagged with the site name), so legacy configs are
        unchanged."""
        from repro_torch.configs import plan as _plan
        return _plan.site_config(self, site)

    @property
    def resolved_tdvmm_plan(self):
        """The concrete site table (``repro_torch.configs.plan.ResolvedPlan``)."""
        from repro_torch.configs import plan as _plan
        return _plan.resolve_plan(self)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, self.vocab_pad_multiple)

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k? (SSM/hybrid or sliding-window attn)."""
        return self.family in ("ssm", "hybrid") or self.swa_window is not None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS and memory checks)."""
        d, hd = self.d_model, self.resolved_head_dim
        v = self.padded_vocab
        n = 0
        n += v * d                                   # embed
        if not self.tie_embeddings:
            n += d * v                               # lm head
        per_attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.qkv_bias:
            per_attn += (self.n_heads + 2 * self.n_kv_heads) * hd
        def ffn_params(dff):
            if self.act == "silu_glu":
                return 3 * d * dff
            return 2 * d * dff
        if self.family in ("dense", "vlm", "audio"):
            n += self.n_layers * (per_attn + ffn_params(self.d_ff) + 2 * d)
        elif self.family == "moe":
            m = self.moe
            moe_layers = self.n_layers - m.first_k_dense
            n += self.n_layers * (per_attn + 2 * d)
            n += m.first_k_dense * ffn_params(self.d_ff)
            n += moe_layers * (m.n_experts + m.n_shared_experts) * ffn_params(m.d_ff)
            n += moe_layers * d * m.n_experts        # router
        elif self.family in ("ssm", "hybrid"):
            s = self.ssm
            d_inner = s.expand * d
            n_ssm_heads = d_inner // s.head_dim
            per_ssm = d * (2 * d_inner + 2 * s.n_groups * s.d_state + n_ssm_heads) \
                + d_inner * d + 3 * n_ssm_heads + 2 * d \
                + s.d_conv * (d_inner + 2 * s.n_groups * s.d_state)
            n += self.n_layers * per_ssm
            if self.family == "hybrid" and self.hybrid_attn_every:
                shared = per_attn + ffn_params(self.d_ff) + 2 * d
                if self.hybrid_concat_embed:
                    shared += 2 * d * d
                n += shared                          # one shared block
        n += d                                       # final norm
        return n

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only top_k + shared experts)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        d = self.d_model
        def ffn_params(dff):
            return (3 if self.act == "silu_glu" else 2) * d * dff
        total = self.param_count()
        moe_layers = self.n_layers - m.first_k_dense
        inactive = moe_layers * (m.n_experts - m.top_k) * ffn_params(m.d_ff)
        return total - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode
    microbatch_per_shard: int = 0   # 0 -> auto (see launch/train.py)


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"             # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    moment_dtype: str = "float32"   # bf16 moments for the 1T-param config
    grad_compression: str = "none"  # none | int8  (error-feedback all-reduce)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    seed: int = 0
    checkpoint_dir: str = "/tmp/repro_ckpt"
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    log_every: int = 10
