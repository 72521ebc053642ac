"""Core time-domain VMM library (the paper's contribution), torch port.

The layer objects (``TDVMMLayerConfig``, ``TDVMMLinear``, ``td_matmul``)
are re-exported lazily (PEP 562): ``repro_torch.core.layers`` imports
``repro_torch.configs.base`` for the config types, which imports
``repro_torch.core.constants`` for ``TDVMMSpec``; an eager re-export here
would close that loop into a circular import.
"""
from repro_torch.core.constants import TDVMMSpec

__all__ = ["TDVMMSpec", "TDVMMLayerConfig", "TDVMMLinear", "td_matmul"]

_LAZY = {name: "repro_torch.core.layers" for name in __all__[1:]}


def __getattr__(name: str):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(target), name)
