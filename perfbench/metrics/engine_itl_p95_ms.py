"""engine_itl_p95_ms: ``itl_p95_ms``'s statistic in a cell whose few long
prompt chunks decide it, so that it swings with the seed: a per-layer
metric there."""
from perfbench.metrics import itl_p95_ms


def read(rec, suffix):
    return itl_p95_ms.read(rec, suffix)
