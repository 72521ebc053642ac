"""idle_in_program.<kind>: the share of the traced window in which no
operation ran on the device while the host was inside one of the
program's ``model.*`` ranges (a model step, and everything nested in it);
``device_idle.<kind>`` less this is the idle time the benchmark's loop
and the engine hold outside the model (profiler trace)."""
from perfbench import devtrace, spans


def read(rec, suffix):
    if rec.events is None or suffix != rec.kind:
        return None
    idle = spans.idle_inside_s(rec.events, spans.MODEL_PREFIX)
    lo, hi = devtrace.window(rec.events)
    win = (hi - lo) / 1e9
    return None if idle is None or win <= 0 else 100.0 * idle / win
