"""The reduction of a trace: busy time as a union of device intervals,
each kernel's time by its symbol, and idle gaps named by the host op that
ran across them."""

import pytest

from benchlib import trace
from benchlib.trace import Event


def synthetic():
    """A 100 us window: two overlapping kernels (10-40, 30-50), a copy
    (70-80), host ops: the window, two ops (0-58, 55-65) and a sync
    (66-100)."""
    return [
        Event(trace.WINDOW_SPAN, False, 0.0, 100.0),
        Event("aten::mul", False, 0.0, 58.0),
        Event("aten::add", False, 55.0, 65.0),
        Event("cudaStreamSynchronize", False, 66.0, 100.0),
        Event("void (anonymous namespace)::composite_bwd_kernel<6>(float "
              "const*, int)", True, 10.0, 40.0),
        Event("void at::native::vectorized_elementwise_kernel<4>(int)",
              True, 30.0, 50.0),
        Event("Memcpy DtoH (Device -> Pageable)", True, 70.0, 80.0),
    ]


def test_busy_is_the_union_not_the_sum():
    s = trace.summarize(synthetic())
    assert s.window_s == pytest.approx(100e-6)
    # 10-50 and 70-80: 50 us, not 30 + 20 + 10 = 60.
    assert s.busy_s == pytest.approx(50e-6)
    assert sum(s.device_s.values()) == pytest.approx(60e-6)


def test_idle_gaps_named_by_the_innermost_host_op():
    s = trace.summarize(synthetic())
    # Gaps 0-10 (midpoint 5: aten::mul), 50-70 (midpoint 60: aten::add,
    # the one still running), 80-100 (cudaStreamSynchronize).
    assert s.idle_by_host == pytest.approx({
        "aten::mul": 10e-6, "aten::add": 20e-6,
        "cudaStreamSynchronize": 20e-6})


def test_symbols():
    s = trace.summarize(synthetic())
    assert s.symbol_s["composite_bwd_kernel"] == pytest.approx(30e-6)
    assert s.symbol_s["vectorized_elementwise_kernel"] == pytest.approx(20e-6)
    assert trace.symbol("void (anonymous namespace)::composite_kernel<6>("
                        "float const*, float*)") == "composite_kernel"
    assert trace.symbol("sm80_xmma_gemm_f32f32_f32f32_f32_nt_n") == \
        "sm80_xmma_gemm_f32f32_f32f32_f32_nt_n"


def test_events_outside_the_window_are_clipped():
    ev = synthetic() + [Event("late_kernel", True, 90.0, 130.0)]
    s = trace.summarize(ev)
    assert s.busy_s == pytest.approx(60e-6)
    assert s.device_s["late_kernel"] == pytest.approx(10e-6)


def test_no_window_or_no_device_work_raises():
    with pytest.raises(ValueError):
        trace.summarize([e for e in synthetic()
                         if e.name != trace.WINDOW_SPAN])
    with pytest.raises(ValueError):
        trace.summarize([e for e in synthetic() if not e.on_device])


def test_breakdown_keeps_the_ten_largest():
    d = {f"op{i}": float(i) for i in range(15)}
    s = trace.TraceSummary(1.0, 0.5, d, d, d)
    b = trace.breakdown(s)
    assert [n for n, _ in b["device_ops"]] == [f"op{i}"
                                               for i in range(14, 4, -1)]
    assert b["idle_gaps"][0] == ["op14", 14.0]
