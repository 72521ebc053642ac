"""tick_device_ms_p50.engine: the median over the window's engine ticks
of the device time (overlaps counted once) of the operations queued inside
each tick's ``engine.tick`` range, wherever they ran after it returned
(profiler trace); ``tick_ms_p50.engine`` is the same tick's host time."""
from perfbench import spans
from perfbench.metrics._stats import pct


def read(rec, suffix):
    if rec.events is None:
        return None
    v = pct(spans.per_range_device_s(rec.events, spans.TICK), 50)
    return None if v is None else 1e3 * v
