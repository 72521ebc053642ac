"""step_mfu.<kind>: the least time of the window's model FLOPs (TD-VMM
site operations at the int8 peak, the rest at the configuration's dtype
peak; counted by ``perfbench.work`` from the configuration and the tokens
sent) over the window.  Read in the traced run."""


def read(rec, suffix):
    if rec.events is None or suffix != rec.kind or not rec.window_s:
        return None
    return 100.0 * rec.work.least_s(rec.peaks, rec.dtype) / rec.window_s
