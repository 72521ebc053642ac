"""device_idle.<kind>: the share of the traced window in which no
operation ran on the device (profiler trace)."""
from perfbench import devtrace


def read(rec, suffix):
    if rec.events is None or suffix != rec.kind:
        return None
    busy, win = devtrace.busy_s(rec.events)
    return 100.0 * (1.0 - busy / win) if win > 0 else None
