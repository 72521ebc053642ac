"""itl_p95_ms: the 95th percentile of every gap between two successive
tokens of one sequence in the window, each token timed when it reached
the host."""
from perfbench.metrics._stats import pct


def read(rec, suffix):
    v = pct(rec.itl_s, 95)
    return None if v is None else 1e3 * v
