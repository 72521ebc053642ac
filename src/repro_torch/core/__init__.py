"""Core time-domain VMM library (the paper's contribution), torch port."""
from repro_torch.core.constants import TDVMMSpec

__all__ = ["TDVMMSpec"]
