"""program_share.<kind>: the share of the traced window in which a device
operation queued inside the program's ``tdvmm.program`` range (one call of
``core/quant.program_weights``: weight programming) ran, wherever it ran
after the range closed; overlaps counted once (profiler trace)."""
from perfbench import devtrace, spans


def read(rec, suffix):
    if rec.events is None or suffix != rec.kind:
        return None
    own = spans.owned_s(rec.events, spans.PROGRAM)
    lo, hi = devtrace.window(rec.events)
    win = (hi - lo) / 1e9
    return None if own is None or win <= 0 else 100.0 * own / win
