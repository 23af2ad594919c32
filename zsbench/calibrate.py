"""Readings that a cell's limits are set from, in one process on the card.

    python3 -m zsbench.calibrate --workload <cell> --seeds 1,2,... [--control-seeds ...] [--fault-seeds ...]

For every seed of ``--seeds`` the program runs as the cell sets it up (a
window of the mix's traced length, no profiler) and the check's numbers
are printed: the lower readings. For every seed of ``--control-seeds`` the
control (the reference under fp8 matmuls, in the program's place) is read:
the upper readings. For every seed of ``--fault-seeds`` each fault the cell
can have is planted and read: in the outputs the program produced, or, for
a fault of the program's path, in a run of its own with the fault planted.
One JSON line a reading; the last line holds each number's largest sound
reading and smallest control and fault readings. The benchmark's own runs
never run this.
"""

import argparse
import contextlib
import functools
import gc
import json
import os

import torch

from zsbench import manifest
from zsbench.reference.precision import fp8_matmuls
from zsbench.run import cache_dirs, require_cards


def swap(keys):
    """A fault that alters an answer where it is produced: the first two
    samples' ``keys`` of a kept call exchanged."""
    def fault(kept):
        out = dict(kept)
        for k in keys:
            v = kept[k].clone() if isinstance(kept[k], torch.Tensor) else kept[k].copy()
            v[[0, 1]] = v[[1, 0]]
            out[k] = v
        return out
    return fault


def move(key, by):
    """A fault that alters an answer where it is produced: the first sample's
    points ``key`` moved by ``by`` along x."""
    def fault(kept):
        v = kept[key].clone()
        v[0, :, 0] += by
        return dict(kept, **{key: v})
    return fault


@contextlib.contextmanager
def half_rotations():
    """The program's best-of-rotations search over every other rotation of
    the sphere only. (The first half of the azimuths alone is no fault on
    these objects: their symmetries bring the best rotation into it.)"""
    from zeroshape_tpu_torch.metrics import eval3d

    full = eval3d.get_rotation_sphere
    eval3d.get_rotation_sphere = lambda *a, **kw: full(*a, **kw)[::2]
    try:
        yield
    finally:
        eval3d.get_rotation_sphere = full


RECON_OUTPUTS = ("depth", "intr", "level")
FAULTS = {"recon": {"swapped_samples": swap(RECON_OUTPUTS + ("world",)),
                    "moved_samples": move("world", 3.0 / 128)},
          "score": {"swapped_samples": swap(RECON_OUTPUTS + ("pred_n", "gt_n")),
                    "swapped_metrics": swap(("acc", "comp", "f")),
                    "moved_samples": move("pred_n", 0.01)},
          "train": {"half_batch": "half_batch", "unchanged": "unchanged"}}
PATH_FAULTS = {"score": {"half_rotations": half_rotations}}
WITNESS = functools.partial(torch.autocast, "cuda", dtype=torch.bfloat16)  # bf16 compute, as the program's


def program_run(kind, cfg, mix, seed, device, planted=contextlib.nullcontext):
    """The program as a cell sets it up, through a window of the mix's traced length, its state then freed."""
    with planted():
        runner = manifest.runner(kind).Runner(cfg, mix, seed, device)
        runner.setup()
        runner.traced_units()
        if hasattr(runner, "after_trace"):
            runner.after_trace()
    runner.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return runner


def readings(workload, seeds, control_seeds, fault_seeds, root=manifest.ROOT, here=manifest.HERE, witness=False,
             details=None):
    bench = manifest.load(root)
    cell = manifest.cell(bench, workload)
    cfg = manifest.config(bench, cell["config"], root)
    mix = manifest.traffic(cell["traffic"], here)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    kind = mix["runner"]
    out = {}

    def record(seed, what, name, runner, **kw):
        numbers = runner.check(**kw)
        print(json.dumps({"workload": workload, "seed": seed, "reading": what, "name": name, **numbers}), flush=True)
        if details:
            os.makedirs(details, exist_ok=True)
            with open(os.path.join(details, f"details_{workload}.jsonl"), "a") as fh:
                fh.write(json.dumps({"seed": seed, "reading": what, "name": name,
                                     "details": getattr(runner, "details", None)}, default=str) + "\n")
        for k, v in numbers.items():
            out.setdefault(what, {}).setdefault(k, []).append(v)

    for seed in sorted(set(seeds) | set(control_seeds) | set(fault_seeds)):
        runner = program_run(kind, cfg, mix, seed, device)
        if seed in seeds:
            record(seed, "sound", None, runner)
        if seed in control_seeds:
            record(seed, "control", "fp8", runner, control=fp8_matmuls)
            if witness:
                record(seed, "witness", "bf16", runner, control=WITNESS)
        if seed in fault_seeds:
            for name, f in FAULTS[kind].items():
                record(seed, f"fault:{name}", name, runner, fault=f)
        del runner
        gc.collect()
        if seed in fault_seeds:
            for name, planted in PATH_FAULTS.get(kind, {}).items():
                record(seed, f"fault:{name}", name, program_run(kind, cfg, mix, seed, device, planted))
    summary = {"lower" if what == "sound" else f"{what} min": {k: (max(v) if what == "sound" else min(v))
                                                                for k, v in nums.items()}
               for what, nums in out.items() if nums}
    return out, summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--witness", action="store_true", help="also read the reference under bf16 autocast")
    p.add_argument("--details", metavar="DIR", help="write each reading's per-sample or per-leaf details here")
    a = p.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    cache_dirs(manifest.ROOT)
    require_cards(1)
    _, summary = readings(a.workload, ints(a.seeds), ints(a.control_seeds), ints(a.fault_seeds), witness=a.witness,
                          details=a.details)
    print(json.dumps({"workload": a.workload, "summary": summary, "card": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
