"""tdvmm_roofline.<kind>: the least time of the window's TD-VMM matmuls
(``perfbench.work``: per launch the larger of operations over the int8
peak and bytes over HBM bandwidth, routed rows only) over the device time
of the kernels named below (B1 and B2 of ``kernels/tdvmm``), from the
profiler's trace.  Nothing to read where those kernels did not run."""
from perfbench import devtrace

KERNELS = ("b1_kernel", "b2_integrate", "b2_readout")


def read(rec, suffix):
    if rec.events is None or suffix != rec.kind:
        return None
    t = devtrace.kernel_s(rec.events, KERNELS)
    if t <= 0 or rec.work.td_least_s <= 0:
        return None
    return 100.0 * rec.work.td_least_s / t
