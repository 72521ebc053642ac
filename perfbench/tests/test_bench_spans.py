"""The readers of the program's own profiler ranges (``perfbench/spans.py``
and the metrics on it), on synthetic profiler traces with known answers:
a device operation belongs to the range its launch call started in, even
when it runs after the range closed; nested ranges count once; only the
syncs and the idle time inside the model's ranges count, not the loop's;
a trace without the program's ranges (an older program's) reads nothing;
and the readers that were there read the same numbers with the ranges in
the trace."""
import pytest

from perfbench import devtrace, harness, spans
from perfbench.devtrace import Event
from perfbench.metrics import (device_idle, idle_in_program, program_share,
                               step_syncs, tdvmm_roofline,
                               tick_device_ms_p50)

MS = 1_000_000


def ann(name, a, b):
    return Event(name, a * MS, (b - a) * MS, False, True)


def call(name, a, b=None):
    return Event(name, a * MS, ((b if b is not None else a + 0.01) - a) * MS,
                 False, False)


def op(name, a, b):
    return Event(name, a * MS, (b - a) * MS, True, False)


def static_trace():
    """A 100 ms window of the static decode loop: two ``bench.decode`` steps.
    Kernels K1-K5 launched at 6, 12, 41, 56 and 91 ms, copies queued at 16,
    71 (synchronous) and 80 ms; K1 and K2 inside ``tdvmm.program`` (one
    nested in another), both run after it closed.  Busy 20-46, 47-50,
    60-70, 71-72, 80-81 and 92-94 ms."""
    return [
        ann(devtrace.WINDOW, 0, 100),
        ann("bench.decode", 0, 50),
        ann("model.decode", 2, 40),
        ann("tdvmm.program", 5, 15),
        ann("tdvmm.program", 6, 8),
        call("aten::abs", 5.5, 6.5),
        call("cudaLaunchKernel", 6),
        call("cudaLaunchKernel", 12),
        call("cudaMemcpyAsync", 16),
        call("cudaStreamSynchronize", 17, 45),
        call("cudaLaunchKernel", 41),
        call("cudaStreamSynchronize", 46, 50),     # the loop's read-back
        ann("bench.decode", 55, 95),
        ann("model.decode", 55, 90),
        call("cudaLaunchKernel", 56),
        call("cudaMemcpy", 71, 72),
        call("cudaMemcpyAsync", 80),               # queues, does not wait
        call("cudaLaunchKernel", 91),
        op("K1 abs", 20, 30),
        op("K2 round", 30, 45),
        op("Memcpy DtoH (Device -> Pageable)", 45, 46),
        op("K3 argmax", 47, 50),
        op("K4 b1_kernel", 60, 70),
        op("Memcpy DtoD (Device -> Device)", 71, 72),
        op("Memcpy HtoD (Pageable -> Device)", 80, 81),
        op("K5 copy", 92, 94),
    ]


def engine_trace():
    """Three ``engine.tick`` ranges; the first tick's two kernels overlap
    and run after it returned (12-20 and 18-25 ms: 13 ms merged), the
    second's runs 26-30 ms, the third's 40-50 ms."""
    return [
        ann(devtrace.WINDOW, 0, 60),
        ann("bench.tick", 0, 10), ann("engine.tick", 0, 10),
        ann("model.prefill", 1, 9),
        call("cudaLaunchKernel", 2), call("cudaLaunchKernel", 3),
        ann("bench.tick", 20, 30), ann("engine.tick", 20, 30),
        call("cudaLaunchKernel", 21),
        ann("bench.tick", 30, 60), ann("engine.tick", 30, 60),
        call("cudaLaunchKernel", 31),
        op("a", 12, 20), op("b", 18, 25), op("c", 26, 30), op("d", 40, 50),
    ]


def program_free(events):
    """The trace as a program without the ranges records it."""
    return [e for e in events if not (e.annotation and (
        e.name.startswith(spans.MODEL_PREFIX)
        or e.name in (spans.PROGRAM, spans.TICK)))]


def record(events, kind="decode"):
    return harness.Record(kind=kind, window_s=0.1, events=events)


def test_launches_pair_with_operations_by_kind_and_order():
    pairs = {e.name: t / MS for t, e in spans.launched(static_trace())}
    assert pairs == {"K1 abs": 6, "K2 round": 12, "K3 argmax": 41,
                     "K4 b1_kernel": 56, "K5 copy": 91,
                     "Memcpy DtoH (Device -> Pageable)": 16,
                     "Memcpy DtoD (Device -> Device)": 71,
                     "Memcpy HtoD (Pageable -> Device)": 80}


def test_program_share_counts_what_ran_after_the_range_once():
    ev = static_trace()
    # K1 and K2, launched inside the (nested) ranges, ran 20-45 ms
    assert spans.owned_s(ev, spans.PROGRAM) == pytest.approx(0.025)
    assert program_share.read(record(ev), "decode") == pytest.approx(25.0)
    assert program_share.read(record(ev), "prefill") is None


def test_syncs_count_inside_the_model_step_only():
    # the stream sync at 17 ms and the synchronous copy at 71 ms; not the
    # loop's read-back at 46 ms nor the queued copy at 80 ms
    assert step_syncs.read(record(static_trace()), "decode") == \
        pytest.approx(1.0)


def test_idle_counts_inside_the_model_step_only():
    ev = static_trace()
    # idle 2-20, 55-60, 70-71, 72-80 and 81-90 ms inside model.decode;
    # 46-47 ms (the loop's read-back) and 50-55 ms lie outside it
    assert spans.idle_inside_s(ev, spans.MODEL_PREFIX) == \
        pytest.approx(0.041)
    assert idle_in_program.read(record(ev), "decode") == pytest.approx(41.0)
    assert device_idle.read(record(ev), "decode") == pytest.approx(57.0)


def test_tick_device_time_is_the_ticks_own_kernels():
    ev = engine_trace()
    assert spans.per_range_device_s(ev, spans.TICK) == \
        pytest.approx([0.013, 0.004, 0.010])
    assert tick_device_ms_p50.read(record(ev), "engine") == \
        pytest.approx(10.0)


@pytest.mark.parametrize("trace", [static_trace, engine_trace])
def test_a_trace_without_the_ranges_reads_nothing(trace):
    rec = record(program_free(trace()))
    assert program_share.read(rec, "decode") is None
    assert step_syncs.read(rec, "decode") is None
    assert idle_in_program.read(rec, "decode") is None
    assert tick_device_ms_p50.read(rec, "engine") is None
    assert tick_device_ms_p50.read(record(None), "engine") is None


@pytest.mark.parametrize("trace", [static_trace, engine_trace])
def test_the_earlier_readers_read_the_same_with_the_ranges(trace):
    ev, old = trace(), program_free(trace())
    assert len(old) < len(ev)
    assert devtrace.busy_s(ev) == devtrace.busy_s(old)
    assert devtrace.top_ops(ev) == devtrace.top_ops(old)
    assert devtrace.idle_gaps(ev) == devtrace.idle_gaps(old)
    assert devtrace.kernel_s(ev, tdvmm_roofline.KERNELS) == \
        devtrace.kernel_s(old, tdvmm_roofline.KERNELS)
    assert device_idle.read(record(ev), "decode") == \
        device_idle.read(record(old), "decode")
