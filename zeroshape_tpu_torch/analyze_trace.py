"""Summarise a torch profiler trace: where the host's and the card's time
went (counterpart of ``scripts/analyze_trace.py``).

    python -m zeroshape_tpu_torch.analyze_trace [logdir_or_trace] [top_n]

Reads the Chrome trace that ``torch.profiler`` writes: a ``*.pt.trace.json``
or ``*.pt.trace.json.gz`` that ``runtime/engine_base.ProfilerSchedule``
(``--debug --profile``) leaves under ``debug/profiler_log/window_i`` (the
default; the newest file under it), ``profile_train --trace=FILE`` writes,
or any file named on the command line. Prints:

* per-lane totals (a lane is a process, the host's threads or the card's
  streams) of self times, an event's duration less its direct children's
  (:func:`self_times`), and the top ``top_n`` events by self time (host
  operators and device kernels; Python frames left out);
* the card's kernels (kernels, copies, memsets) summed by the
  ``record_function`` span that encloses each one's launch (the innermost;
  ``train_forward``, ``train_loss``, ``train_backward``, ``optimizer_step``
  of a training step, ``encode_image``, ``latent_trunk``, ``grid_decode``,
  ``surface_sample`` of a reconstruction), and by the outermost span; what
  the spans hold against the device's busy time (the kernels' summed
  durations). This replaces the JAX script's ``tf_op`` segments: a
  kernel's launch is tied to its host call by the trace's correlation id,
  and where a trace lacks it, to the span's own device-side lane
  (``gpu_user_annotation``) that holds the kernel's start.

The last line is one JSON object of these numbers, with the card the trace
was recorded on and, where ``nvidia-smi`` answers, this host's card and its
power limit. A trace without a single device kernel raises: it says nothing
about the card.
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
import subprocess
import sys
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STEP_PREFIX = "ProfilerStep#"
NO_SPAN = "(no span)"


def find_trace(path):
    """``path`` itself if it is a file, else the newest trace file under it."""
    if os.path.isfile(path):
        return path
    hits = [p for pat in ("*.pt.trace.json", "*.pt.trace.json.gz", "*.trace.json", "*.trace.json.gz")
            for p in glob.glob(os.path.join(path, "**", pat), recursive=True)]
    if not hits:
        raise SystemExit(f"no .pt.trace.json(.gz) under {path}")
    return max(set(hits), key=os.path.getmtime)


def load(trace):
    opener = gzip.open if trace.endswith(".gz") else open
    with opener(trace, "rt") as f:
        return json.load(f)


def self_times(evs):
    """Per-event SELF time for one thread lane: an event's duration minus its
    DIRECT children's (complete events nest within a lane, so summing raw
    durations would count inner frames many times over). Returns
    ``[(name, self_time), ...]``; grandchildren are charged to their own
    parent, not to the outermost frame."""
    evs = sorted(evs, key=lambda e: (e["ts"], -e["dur"]))
    stack = []  # (end_ts, index into records of the open frame)
    records = []  # [name, dur, child_time]
    for e in evs:
        ts, dur = e["ts"], e["dur"]
        while stack and ts >= stack[-1][0] - 1e-9:
            stack.pop()
        if stack:
            records[stack[-1][1]][2] += dur  # direct child of the top
        records.append([e["name"], dur, 0.0])
        stack.append((ts + dur, len(records) - 1))
    return [(name, max(dur - child, 0.0)) for name, dur, child in records]


# a span path (outer/inner record_function names, or a JAX tf_op path) to a
# model segment
_SEGMENTS = (
    ("dpt_depth", "DPT depth net"),
    ("coord_encoder", "coord encoder"),
    ("impl_network.decode", "implicit decode"),
    ("impl_network.encode", "implicit encode"),
    ("intr_", "intr head"),
    ("loss", "losses"),
)


def segment(path):
    """Map a span path to ``"<model segment> (fwd|bwd)"``: backward work is
    marked ``transpose(jvp(...))`` in a JAX path, and runs under
    ``train_backward`` (or an autograd ``...Backward`` node) in the port's."""
    d = "bwd" if any(m in path for m in ("transpose(jvp", "train_backward", "Backward")) else "fwd"
    for pat, lab in _SEGMENTS:
        if pat in path:
            return f"{lab} ({d})"
    return f"other ({d})"


def lanes(events):
    """``(pid names, (pid, tid) names)`` from the trace's metadata events."""
    pid_names, tid_names = {}, {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_names[e["pid"]] = str(e.get("args", {}).get("name", e["pid"]))
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            tid_names[(e["pid"], e["tid"])] = str(e.get("args", {}).get("name", ""))
    return pid_names, tid_names


def lane_totals(events, pid_names, tid_names):
    """``(lane totals {lane: us}, {(lane, name): [us, count]})`` of self times
    (the profiler's own whole-trace span left out)."""
    by_thread = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and "dur" in e and e.get("cat") != "Trace":
            by_thread[(e.get("pid"), e.get("tid"))].append(e)
    lane_dur, op = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for (pid, tid), evs in by_thread.items():
        lane = pid_names.get(pid, str(pid))
        thread = tid_names.get((pid, tid))
        lane = f"{lane} / {thread}" if thread else lane
        for name, self_t in self_times(evs):
            lane_dur[lane] += self_t
            op[(lane, name)][0] += self_t
            op[(lane, name)][1] += 1
    return dict(lane_dur), dict(op)


class _Spans:
    """Intervals of one kind of span, for the innermost one holding a time."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda e: (e["ts"], -e["dur"]))
        self.starts = [e["ts"] for e in self.spans]

    def path(self, t):
        """Names of the spans holding ``t``, outermost first."""
        i = bisect.bisect_right(self.starts, t)
        return [e["name"] for e in self.spans[:i] if t < e["ts"] + e["dur"]]


def summarize_device_ops(events, top_n=20):
    """The card's kernels summed by the span that encloses their launch.

    Returns ``{device_busy_ms, kernels, steps, spans, spans_outer, span_sum_ms,
    span_share, segments, top}`` (ms; ``steps`` the trace's profiler steps,
    None where it has none) and prints it. Raises ``RuntimeError`` for a
    trace with no device kernel."""
    kernels = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and "dur" in e]
    if not kernels:
        raise RuntimeError("no CUDA device kernels in the trace: it was not recorded on a card, or without "
                           "ProfilerActivity.CUDA")
    user = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation" and "dur" in e]
    host = _Spans([e for e in user if not e["name"].startswith(STEP_PREFIX)])
    device = _Spans([e for e in events if e.get("ph") == "X" and e.get("cat") == "gpu_user_annotation"
                     and "dur" in e])
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    inner, outer, segs, by_name = defaultdict(float), defaultdict(float), defaultdict(float), defaultdict(lambda: [0, 0])
    busy = 0.0
    for k in kernels:
        corr = k.get("args", {}).get("correlation")
        path = host.path(launch[corr]) if corr in launch else device.path(k["ts"])
        busy += k["dur"]
        inner[path[-1] if path else NO_SPAN] += k["dur"]
        outer[path[0] if path else NO_SPAN] += k["dur"]
        segs[segment("/".join(path + [k["name"]]))] += k["dur"]
        by_name[k["name"]][0] += k["dur"]
        by_name[k["name"]][1] += 1
    steps = sum(e["name"].startswith(STEP_PREFIX) for e in user) or None
    span_sum = sum(v for n, v in inner.items() if n != NO_SPAN)
    ms = lambda d: {n: v / 1e3 for n, v in sorted(d.items(), key=lambda kv: -kv[1])}
    out = {"device_busy_ms": busy / 1e3, "kernels": len(kernels), "steps": steps, "spans": ms(inner),
           "spans_outer": ms(outer), "span_sum_ms": span_sum / 1e3, "span_share": span_sum / busy,
           "segments": ms(segs),
           "top": [{"name": n[:120], "ms": v / 1e3, "count": c}
                   for n, (v, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_n]]}
    per = f" ({out['device_busy_ms'] / steps:.3f} ms a step over {steps} steps)" if steps else ""
    print(f"\ndevice: {len(kernels)} kernels, busy {out['device_busy_ms']:.3f} ms{per}; the spans hold "
          f"{out['span_sum_ms']:.3f} ms ({out['span_share']:.1%})")
    print("device time by the innermost span of each kernel's launch:")
    for n, v in out["spans"].items():
        print(f"  {v:10.3f} ms  {100 * v / out['device_busy_ms']:5.1f}%  {n}")
    print("by the outermost span:")
    for n, v in out["spans_outer"].items():
        print(f"  {v:10.3f} ms  {100 * v / out['device_busy_ms']:5.1f}%  {n}")
    print(f"top {top_n} device kernels by time:")
    for t in out["top"]:
        print(f"  {t['ms']:10.3f} ms  x{t['count']:<6d} {t['name'][:100]}")
    return out


def _smi():
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (FileNotFoundError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else None


def analyze(path, top_n=30):
    """Print the summary of the trace at ``path`` (see the module doc) and
    return its JSON record."""
    trace = find_trace(path)
    print(f"trace: {trace}")
    data = load(trace)
    events = data["traceEvents"] if isinstance(data, dict) else data
    pid_names, tid_names = lanes(events)
    lane_dur, op = lane_totals(events, pid_names, tid_names)
    print("\nlane totals (summed self times):")
    for lane, d in sorted(lane_dur.items(), key=lambda kv: -kv[1]):
        print(f"  {d / 1e3:10.1f} ms  {lane}")
    frames = {e["name"] for e in events if e.get("cat") == "python_function"}
    ranked = sorted(((d, c, k) for k, (d, c) in op.items() if k[1] not in frames), reverse=True)
    total = sum(d for d, _, _ in ranked) or 1.0
    print(f"\ntop {top_n} events by total SELF time (Python frames left out, {total / 1e3:.1f} ms summed):")
    for d, c, (lane, name) in ranked[:top_n]:
        print(f"  {d / 1e3:9.2f} ms  {100 * d / total:5.1f}%  x{c:<5d} [{lane[:28]}] {name[:110]}")
    summary = summarize_device_ops(events, top_n)
    props = data.get("deviceProperties") if isinstance(data, dict) else None
    return {"tool": "analyze_trace", "trace": trace, "lanes": {k: v / 1e3 for k, v in lane_dur.items()}, **summary,
            "recorded_on": props[0].get("name") if props else None, "card": _smi()}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    record = analyze(argv[0] if argv else os.path.join("debug", "profiler_log"), int(argv[1]) if len(argv) > 1 else 30)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
