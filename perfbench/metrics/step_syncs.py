"""step_syncs.<kind>: host calls that wait for the device
(``spans.SYNCS``: stream, device and event synchronizations, synchronous
copies) started inside the program's ``model.<kind>`` ranges (one model
step each), per range in the traced window (profiler trace)."""
from perfbench import spans


def read(rec, suffix):
    if rec.events is None or suffix != rec.kind:
        return None
    return spans.syncs_per_range(rec.events, f"{spans.MODEL_PREFIX}{suffix}")
