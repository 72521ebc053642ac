from repro_torch.configs.archs import ARCHS, get_config, smoke
from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    OptimizerConfig,
    RunConfig,
    ShapeConfig,
    SHAPES,
    SSMConfig,
    TDVMMLayerConfig,
    TDVMMPlan,
    TDVMMRule,
    tdvmm_rule,
)
from repro_torch.configs.plan import ResolvedPlan, model_sites, resolve_plan

__all__ = [
    "ARCHS", "get_config", "smoke", "ModelConfig", "MoEConfig",
    "OptimizerConfig", "RunConfig", "ShapeConfig", "SHAPES", "SSMConfig",
    "TDVMMLayerConfig", "TDVMMPlan", "TDVMMRule", "tdvmm_rule",
    "ResolvedPlan", "model_sites", "resolve_plan",
]
