"""Run one cell of the benchmark.

    python3 -m zsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``zsbench/`` and the
port ``zeroshape_tpu_torch``. Set-up (weights and traffic from the seed, on the
device; the program's build, load and warm-up) is timed as ``setup_s``. With
``--trace 0`` the window runs for ``--seconds`` and the cell's end-to-end
metrics are reported; with ``--trace 1`` a short window of the mix's length
runs under the profiler and the cell's per-layer metrics are reported with
the device's busy time, the window's length and a breakdown. Either way the
outputs of the window are then checked against the plain reference (the
program's state freed first), each compared number printed beside its limit
on standard error and in the result's last key. The last line of standard
output is one JSON object. Without a card, with fewer cards than the cell
asks for, or with JAX loaded once the window has closed, the run exits with
a non-zero code and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from zsbench import manifest  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "zeroshape_tpu")


def cache_dirs(root):
    """Build and kernel caches at fixed paths inside the checkout (the port
    builds its own kernels into ``zeroshape_tpu_torch/csrc/build/``), and no
    JAX backend for libraries that would load one."""
    base = os.path.join(root, ".zsbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules():
    """Top-level names in ``sys.modules`` of JAX or the JAX package, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def require_cards(n):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"zsbench: the cell needs {n} CUDA card(s), this machine has {have}", file=sys.stderr)
        raise SystemExit(3)


def judge(numbers, limits):
    """``{name: {value, limit}}`` of the numbers the cell's limits name, and
    whether each is within its limit (a missing or non-finite number is not)."""
    compared = {n: {"value": numbers.get(n, float("inf")), "limit": lim} for n, lim in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in compared.values())
    return compared, ok


def run(args, root=manifest.ROOT, here=manifest.HERE, skip_card_check=False, fault=None):
    """One run; returns the result dict (the JSON line) or raises SystemExit."""
    bench = manifest.load(root)
    cell = manifest.cell(bench, args.workload)
    cfg = manifest.config(bench, cell["config"], root)
    mix = manifest.traffic(cell["traffic"], here)
    limits = manifest.limits(args.workload, here)
    cache_dirs(root)
    if not skip_card_check:
        require_cards(cell["chips"])
    import torch

    from zsbench import tracing

    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    on_card = device.type == "cuda"
    runner = manifest.runner(mix["runner"]).Runner(cfg, mix, args.seed, device)
    runner.setup()
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - T0
    summary = None
    if args.trace:
        units, summary = tracing.traced(runner.traced_units, device) if on_card else (runner.traced_units(), None)
        if hasattr(runner, "after_trace"):
            runner.after_trace()
        e2e = {}
        attempted = units
    else:
        e2e, attempted = runner.window(args.seconds)
    failed = runner.failed() if hasattr(runner, "failed") else 0
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    runner.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = runner.check(fault=fault)
    compared, ok = judge(numbers, limits)
    metrics = {}
    if args.trace:
        ctx = runner.layer_context(summary, attempted)
        ctx["summary"] = summary
        for m in manifest.per_layer(bench, args.workload):
            v = manifest.reader(m["name"]).value(ctx) if summary is not None else None
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e["setup_s"] = setup_s
        for m in manifest.end_to_end(bench, args.workload):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok and failed == 0), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    result["compared"] = compared
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    result = run(args)
    found = forbidden_modules()
    if found:
        print(f"zsbench: JAX or the JAX package is loaded in this process: {', '.join(found)}", file=sys.stderr)
        raise SystemExit(4)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(finite(result)), flush=True)


def finite(obj):
    """``obj`` with every non-finite number as null, so the line stays strict JSON."""
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [finite(v) for v in obj]
    return None if isinstance(obj, float) and not math.isfinite(obj) else obj


if __name__ == "__main__":
    main()
