"""step_ms_p50.<kind>: the median host time of one step of that kind
(prefill, decode, train), each ended by its token or loss read back."""
from perfbench.metrics._stats import pct


def read(rec, suffix):
    v = pct(rec.step_s.get(suffix, []), 50)
    return None if v is None else 1e3 * v
