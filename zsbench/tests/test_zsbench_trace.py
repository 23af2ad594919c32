"""The trace reduction on a small canned Chrome trace."""

import pytest

from zsbench import tracing
from zsbench.readers import idle_pct, kernel_s, span_ms


def ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": 1, "args": args}


EVENTS = [
    ev("zsbench.window", "user_annotation", 0, 1000),
    ev("encode_image", "user_annotation", 10, 300),
    ev("grid_decode", "user_annotation", 400, 500),
    ev("aten::conv2d", "cpu_op", 20, 100),
    ev("aten::sleepy", "cpu_op", 600, 300),
    ev("cudaLaunchKernel", "cuda_runtime", 30, 5, correlation=1),
    ev("cudaLaunchKernel", "cuda_runtime", 420, 5, correlation=2),
    ev("cudaLaunchKernel", "cuda_runtime", 430, 5, correlation=3),
    ev("cudaLaunchKernel", "cuda_runtime", 1200, 5, correlation=4),
    ev("conv_kernel(float*)", "kernel", 100, 200, correlation=1),
    ev("void implicit_decoder_kernel<3>(float const*)", "kernel", 450, 100, correlation=2),
    ev("void implicit_decoder_kernel<3>(float const*)", "kernel", 500, 100, correlation=3),  # overlaps: union
    ev("late_kernel", "kernel", 1300, 50, correlation=4),  # after the window
]


def test_spans_busy_idle_and_counts():
    s = tracing.summarize(EVENTS)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["kernels"] == 3
    assert s["span_s"] == pytest.approx({"encode_image": 200e-6, "grid_decode": 200e-6})
    assert s["busy_s"] == pytest.approx(350e-6)  # 200 + the union 450..600
    assert s["op_count"]["void implicit_decoder_kernel<3>(float const*)"] == 2
    gaps = dict(s["idle_gaps"])
    assert gaps["encode_image / aten::conv2d"] == pytest.approx(100e-6)  # 0..100, middle at 50
    assert gaps["grid_decode / aten::sleepy"] == pytest.approx(400e-6)  # 600..1000
    assert sum(gaps.values()) == pytest.approx(650e-6)
    ctx = {"summary": s, "calls": 2}
    assert span_ms(ctx, "grid_decode", "calls") == pytest.approx(0.1)
    assert idle_pct(ctx) == pytest.approx(65.0)
    assert kernel_s(ctx, "implicit_decoder_kernel") == pytest.approx(200e-6)
    assert kernel_s(ctx, "nn_kernel") is None


def test_a_span_takes_in_the_spans_nested_in_it():
    """torch's own ``Optimizer.step#AdamW.step`` runs inside ``optimizer_step``:
    the kernels launched under it count for both."""
    events = [
        ev("zsbench.window", "user_annotation", 0, 1000),
        ev("optimizer_step", "user_annotation", 100, 600),
        ev("Optimizer.step#AdamW.step", "user_annotation", 150, 400),
        ev("cudaLaunchKernel", "cuda_runtime", 120, 5, correlation=1),
        ev("cudaLaunchKernel", "cuda_runtime", 200, 5, correlation=2),
        ev("cudaLaunchKernel", "cuda_runtime", 800, 5, correlation=3),
        ev("norm_kernel", "kernel", 130, 20, correlation=1),
        ev("multi_tensor_apply_kernel", "kernel", 210, 300, correlation=2),
        ev("late_copy", "kernel", 810, 10, correlation=3),
    ]
    s = tracing.summarize(events)
    assert s["span_s"] == pytest.approx({"optimizer_step": 320e-6, "Optimizer.step#AdamW.step": 300e-6,
                                         tracing.NO_SPAN: 10e-6})
    assert span_ms({"summary": s, "steps": 2}, "optimizer_step", "steps") == pytest.approx(0.16)


def test_a_trace_without_device_work_raises():
    with pytest.raises(RuntimeError):
        tracing.summarize([e for e in EVENTS if e["cat"] != "kernel"])
