"""Order statistics shared by the readers."""
from __future__ import annotations

import numpy as np


def pct(values, q: float):
    """The q-th percentile (linear between order statistics), or None."""
    return float(np.percentile(np.asarray(values, np.float64), q)) \
        if len(values) else None
