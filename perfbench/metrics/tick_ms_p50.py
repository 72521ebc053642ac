"""tick_ms_p50.engine: the median host time of one ``Engine.tick``."""
from perfbench.metrics._stats import pct


def read(rec, suffix):
    v = pct(rec.step_s.get("tick", []), 50)
    return None if v is None else 1e3 * v
