"""Each reader's arithmetic, on a synthetic profiler trace and a synthetic
record."""
import pytest

from perfbench import devtrace, harness, work
from perfbench.devtrace import Event
from perfbench.metrics import (decode_tok_s, device_idle, engine_itl_p95_ms,
                               itl_p95_ms, prefill_tok_s, setup_s, step_mfu,
                               step_ms_p50, tdvmm_roofline, tick_ms_p50)

MS = 1_000_000


def trace():
    """A 100 ms window: B1 20 ms, a copy 10 ms (overlapping B1 by 5 ms),
    B2 10 ms; idle 65 ms, of which 40 ms while the host synchronises
    inside a decode step."""
    return [
        Event(devtrace.WINDOW, 0, 100 * MS, False, True),
        Event("bench.decode", 0, 60 * MS, False, True),
        Event("aten::copy_", 1 * MS, 2 * MS, False, False),
        Event("cudaStreamSynchronize", 20 * MS, 40 * MS, False, False),
        Event("void b1_kernel<64, 1>(TileArgs)", 0, 20 * MS, True, False),
        Event("Memcpy DtoH", 15 * MS, 10 * MS, True, False),
        Event("b2_integrate", 70 * MS, 10 * MS, True, False),
        Event("after the window", 100 * MS, 5 * MS, True, False),
    ]


def record(**kw):
    rec = harness.Record(kind="decode", window_s=0.1, setup_s=12.5,
                         peaks={"int8": 2e12, "bfloat16": 1e12,
                                "hbm_bytes_s": 1e12})
    for k, v in kw.items():
        setattr(rec, k, v)
    return rec


def test_busy_and_kernel_time():
    ev = trace()
    busy, win = devtrace.busy_s(ev)
    assert win == pytest.approx(0.1)
    assert busy == pytest.approx(0.035)
    assert devtrace.kernel_s(ev, ("b1_kernel",)) == pytest.approx(0.02)
    assert devtrace.kernel_s(ev, tdvmm_roofline.KERNELS) == \
        pytest.approx(0.03)


def test_breakdown():
    ev = trace()
    ops = devtrace.top_ops(ev)
    assert ops[0] == ["void b1_kernel<64, 1>(TileArgs)", pytest.approx(0.02)]
    assert len(ops) == 3
    gaps = dict((k, v) for k, v in devtrace.idle_gaps(ev))
    assert gaps["bench.decode / cudaStreamSynchronize"] == \
        pytest.approx(0.045)
    assert gaps["outside any step / no host op"] == pytest.approx(0.02)
    assert sum(gaps.values()) == pytest.approx(0.065)


def test_device_idle_and_roofline():
    rec = record(events=trace())
    assert device_idle.read(rec, "decode") == pytest.approx(65.0)
    assert device_idle.read(rec, "prefill") is None
    rec.work = work.Tally(td_ops=0, other_flops=0, td_least_s=0.003)
    assert tdvmm_roofline.read(rec, "decode") == pytest.approx(10.0)
    assert tdvmm_roofline.read(record(), "decode") is None    # no trace


def test_mfu():
    rec = record(events=trace())
    rec.work = work.Tally(td_ops=2e9, other_flops=1e9)
    # 1 ms + 1 ms of least time over a 100 ms window
    assert step_mfu.read(rec, "decode") == pytest.approx(2.0)


def test_rates_and_tails():
    rec = record(tokens={"decode": 50, "prefill": 400},
                 itl_s=[0.01 * i for i in range(1, 101)],
                 step_s={"decode": [0.1, 0.3, 0.2], "tick": [0.5, 0.7]})
    assert decode_tok_s.read(rec, "") == pytest.approx(500.0)
    assert prefill_tok_s.read(rec, "") is None       # a decode record
    rec.kind = "prefill"
    assert prefill_tok_s.read(rec, "") == pytest.approx(4000.0)
    assert itl_p95_ms.read(rec, "") == pytest.approx(950.5)
    assert engine_itl_p95_ms.read(rec, "") == pytest.approx(950.5)
    assert step_ms_p50.read(rec, "decode") == pytest.approx(200.0)
    assert step_ms_p50.read(rec, "train") is None
    assert tick_ms_p50.read(rec, "engine") == pytest.approx(600.0)
    assert setup_s.read(rec, "") == 12.5
