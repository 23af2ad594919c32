"""The trace analyser (``zeroshape_tpu_torch.analyze_trace``): its pure pieces
against ``scripts/analyze_trace.py`` on the synthetic events of
``tests/test_analyze_trace.py``, and the span aggregation on a small
hand-built torch-style trace."""

import gzip
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import analyze_trace as jax_script  # noqa: E402
from test_analyze_trace import _ev  # noqa: E402
from zeroshape_tpu_torch import analyze_trace  # noqa: E402

LANES = [
    [_ev("A", 0, 100), _ev("B", 10, 40), _ev("C", 60, 20), _ev("D", 15, 10)],
    [_ev("A", 0, 50), _ev("B", 50, 30)],
    [_ev("op", 0, 10), _ev("op", 20, 15)],
    [_ev("B", 10, 0), _ev("A", 0, 30)],
    [_ev("A", 0, 10), _ev("B", 1, 12)],
]


@pytest.mark.parametrize("evs", LANES)
def test_self_times_are_the_jax_scripts(evs):
    assert analyze_trace.self_times(evs) == jax_script.self_times(evs)


@pytest.mark.parametrize("path", ["jit(step)/dpt_depth/conv", "jit(step)/transpose(jvp(dpt_depth))/conv",
                                  "jit(step)/impl_network.decode/mlp", "jit(step)/something_else",
                                  "jit(eval)/impl_network.encode/x", "jit(step)/intr_head/dense",
                                  "jit(step)/coord_encoder/conv", "jit(step)/loss/mean"])
def test_segment_is_the_jax_scripts(path):
    assert analyze_trace.segment(path) == jax_script.segment(path)


def test_segment_reads_the_ports_backward():
    assert analyze_trace.segment("train_backward/aten::convolution_backward") == "other (bwd)"
    assert analyze_trace.segment("train_loss/aten::sum") == "losses (fwd)"


def _torch_trace():
    """Two steps of a torch-style trace: host spans on the main thread, the
    launches (one from the autograd thread inside train_backward), the
    kernels on a stream, a copy with no correlation (placed by its device
    span), and a kernel launched outside every span."""
    host, gpu = 100, 0

    def x(cat, name, ts, dur, pid=host, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid, "args": args}

    ev = [{"ph": "M", "name": "process_name", "pid": host, "args": {"name": "python"}},
          {"ph": "M", "name": "process_name", "pid": gpu, "args": {"name": "GPU 0"}},
          {"ph": "M", "name": "thread_name", "pid": gpu, "tid": 7, "args": {"name": "stream 7"}},
          x("Trace", "PyTorch Profiler (0)", 0, 1000)]
    corr = iter(range(1, 100))
    for step, t0 in ((0, 0), (1, 500)):
        ev.append(x("user_annotation", f"ProfilerStep#{step}", t0, 400))
        for name, start, dur, kdur, tid in (("train_forward", 10, 100, 30, 1), ("train_loss", 120, 20, 4, 1),
                                           ("train_backward", 150, 150, 60, 2), ("optimizer_step", 310, 50, 10, 1)):
            ev.append(x("user_annotation", name, t0 + start, dur))
            c = next(corr)
            ev.append(x("cuda_runtime", "cudaLaunchKernel", t0 + start + dur / 2, 2, tid=tid, correlation=c))
            ev.append(x("kernel", f"{name}_kernel", t0 + start + dur / 2 + 3, kdur, pid=gpu, tid=7, correlation=c))
        ev.append(x("gpu_user_annotation", "train_forward", t0 + 60, 80, pid=gpu, tid=7))
        ev.append(x("gpu_memcpy", "Memcpy HtoD", t0 + 70, 5, pid=gpu, tid=7))
    c = next(corr)
    ev.append(x("cuda_runtime", "cudaLaunchKernel", 950, 2, correlation=c))
    ev.append(x("kernel", "stray", 960, 1, pid=gpu, tid=7, correlation=c))
    return {"traceEvents": ev, "deviceProperties": [{"name": "NVIDIA H100 80GB HBM3"}]}


def test_spans_hold_the_kernels_launched_inside_them(capsys):
    out = analyze_trace.summarize_device_ops(_torch_trace()["traceEvents"])
    assert out["kernels"] == 11 and out["steps"] == 2
    assert out["device_busy_ms"] == pytest.approx(2 * (30 + 4 + 60 + 10 + 5) / 1e3 + 1e-3)
    assert out["spans"] == pytest.approx({"train_forward": 2 * 35e-3, "train_backward": 2 * 60e-3,
                                          "optimizer_step": 2 * 10e-3, "train_loss": 2 * 4e-3, "(no span)": 1e-3})
    assert out["span_sum_ms"] == pytest.approx(out["device_busy_ms"] - 1e-3)
    assert out["span_share"] == pytest.approx(out["span_sum_ms"] / out["device_busy_ms"])
    assert out["segments"]["other (bwd)"] == pytest.approx(2 * 60e-3) and out["top"][0]["name"] == "train_backward_kernel"


def test_nested_spans_give_the_innermost_and_the_outermost():
    ev = _torch_trace()["traceEvents"]
    ev.append({"ph": "X", "cat": "user_annotation", "name": "encode_image", "ts": 20, "dur": 80, "pid": 100, "tid": 1})
    out = analyze_trace.summarize_device_ops(ev)
    assert out["spans"]["encode_image"] == pytest.approx(30e-3)  # step 0's forward kernel
    assert out["spans_outer"]["train_forward"] == pytest.approx(2 * 35e-3)


def test_analyze_reads_the_newest_trace_and_prints_json(tmp_path, capsys):
    old = tmp_path / "window_0" / "host_1.pt.trace.json"
    old.parent.mkdir()
    old.write_text(json.dumps({"traceEvents": []}))
    new = tmp_path / "window_1" / "host_2.pt.trace.json.gz"
    new.parent.mkdir()
    with gzip.open(new, "wt") as f:
        json.dump(_torch_trace(), f)
    os.utime(old, (1, 1))
    analyze_trace.main([str(tmp_path), "3"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["trace"] == str(new) and rec["recorded_on"] == "NVIDIA H100 80GB HBM3" and len(rec["top"]) == 3
    assert "PyTorch Profiler (0)" not in str(rec["lanes"]) and rec["lanes"]["GPU 0 / stream 7"] > 0


def test_a_trace_without_kernels_raises(tmp_path):
    trace = tmp_path / "cpu.pt.trace.json"
    trace.write_text(json.dumps({"traceEvents": [e for e in _torch_trace()["traceEvents"] if e.get("pid") != 0]}))
    with pytest.raises(RuntimeError, match="no CUDA device kernels"):
        analyze_trace.analyze(str(trace))
