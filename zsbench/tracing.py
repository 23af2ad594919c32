"""A traced window and its reduction to the numbers the per-layer metrics read.

:func:`traced` runs a function under ``torch.profiler`` (host and CUDA
activities) inside the benchmark's own span ``zsbench.window``, writes the
Chrome trace under ``TMPDIR``, reduces it with :func:`summarize` and deletes
it. The reduction is the arithmetic of the port's ``analyze_trace`` frozen
here, but for one change: each device operation (kernel, copy, memset) is
charged to every host span (``record_function``) that held its launch,
found by the launch's correlation id, so that a span's time takes in what
ran under the spans nested in it (torch's own ``Optimizer.step#AdamW.step``
inside the port's ``optimizer_step``); the device is busy on the union of
the operations' intervals inside the window; an idle gap is named by what the host was doing
at its middle (its innermost span and operator).
"""

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

WINDOW = "zsbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NO_SPAN = "(no span)"


class _Intervals:
    """Complete events of one kind, for the innermost one holding a time."""

    def __init__(self, events):
        self.events = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
        self.starts = [e["ts"] for e in self.events]

    def innermost(self, t, default):
        """The name of the latest-starting event that holds ``t`` (for nested
        events, the innermost), looking back over at most 4096 events."""
        i = bisect.bisect_right(self.starts, t)
        for j in range(i - 1, max(-1, i - 4097), -1):
            if t < self.events[j]["ts"] + self.events[j]["dur"]:
                return self.events[j]["name"]
        return default

    def holding(self, t):
        """The names of all events that hold ``t``, each once, looking back
        over at most 4096 events."""
        i = bisect.bisect_right(self.starts, t)
        return {self.events[j]["name"] for j in range(i - 1, max(-1, i - 4097), -1)
                if t < self.events[j]["ts"] + self.events[j]["dur"]}


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events, top=10):
    """The window's numbers from a Chrome trace's events (times in seconds).

    Returns ``{window_s, busy_s, kernels, span_s {span: s (inclusive)}, op_s {name: s},
    op_count {name: n}, device_ops [[name, s]], idle_gaps [[name, s]]}``.
    Raises when the trace holds no device operation in the window."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in complete if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    if not win:
        raise RuntimeError(f"no {WINDOW} span in the trace")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    spans = _Intervals([e for e in complete if e.get("cat") == "user_annotation" and e["name"] != WINDOW
                        and not e["name"].startswith("ProfilerStep#")])
    ops = _Intervals([e for e in complete if e.get("cat") == "cpu_op"])
    launch = {e["args"]["correlation"]: e["ts"] for e in complete
              if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    dev = [e for e in complete if e.get("cat") in DEVICE_CATS and w0 <= e["ts"] < w1]
    if not dev:
        raise RuntimeError("no device operation in the traced window: it was not recorded on a card")
    span_s, op_s, op_count = defaultdict(float), defaultdict(float), defaultdict(int)
    for k in dev:
        corr = k.get("args", {}).get("correlation")
        for name in (spans.holding(launch[corr]) if corr in launch else ()) or (NO_SPAN,):
            span_s[name] += k["dur"] / 1e6
        op_s[k["name"]] += k["dur"] / 1e6
        op_count[k["name"]] += 1
    busy = _union([(k["ts"], min(k["ts"] + k["dur"], w1)) for k in dev])
    gaps, prev = defaultdict(float), w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            mid = (a + prev) / 2
            gaps[f"{spans.innermost(mid, NO_SPAN)} / {ops.innermost(mid, 'no operator')}"] += (a - prev) / 1e6
        prev = max(prev, b)
    ranked = lambda d: [[n, v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"window_s": (w1 - w0) / 1e6, "busy_s": sum(b - a for a, b in busy) / 1e6, "kernels": len(dev),
            "span_s": dict(span_s), "op_s": dict(op_s), "op_count": dict(op_count),
            "device_ops": ranked(op_s), "idle_gaps": ranked(gaps)}


def traced(fn, device):
    """Run ``fn()`` under the profiler; returns ``(fn's result, summary)``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            out = fn()
            torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        t0 = time.perf_counter()
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    summary = summarize(data["traceEvents"] if isinstance(data, dict) else data)
    summary["reduce_s"] = time.perf_counter() - t0
    return out, summary
