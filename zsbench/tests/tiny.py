"""A tiny root for the CPU tests: the shipped architecture at narrow widths
and 32^2 images, tiny mixes of each runner, and a BENCHMARK.json naming them."""

import copy
import json
from pathlib import Path

from zsbench import manifest


def tiny_config(vit=False):
    cfg = json.loads((manifest.HERE / "configs" / ("zeroshape_vit.json" if vit else "zeroshape.json")).read_text())
    o = cfg["options"]
    o["H"] = o["W"] = 32
    o["arch"]["latent_dim"] = 64
    o["arch"]["impl"].update(n_channels=64, mlp_layers=4, skip_in=[2])
    o["arch"]["depth"]["n_blocks"] = 2
    o["arch"]["rgb"]["n_blocks"] = 2
    return cfg


MIXES = {
    "recon": {"runner": "recon", "batch": 2, "pool_objects": 2, "views_per_object": 2, "vox_res": 16,
              "range": [-1.5, 1.5], "factor": 4, "capacity": 64, "margin": 0.45, "num_points": 200, "hier": True,
              "sharpen": 25.0, "active_target": 20, "inside": 0.1, "max_calls": 8, "check_calls": 2,
              "check_within": 3, "warmup_calls": 1, "trace_calls": 1},
    "score": {"runner": "score", "batch": 2, "pool_objects": 2, "views_per_object": 1, "gt_points": 200,
              "vox_res": 16, "range": [-1.5, 1.5], "factor": 4, "capacity": 64, "margin": 0.45, "num_points": 200,
              "hier": False, "sharpen": 25.0, "active_target": 20, "inside": 0.1, "rot_samples": [24, 24, 12], "surface_seed": 7, "max_calls": 4,
              "check_calls": 1, "check_within": 2, "warmup_calls": 1, "trace_calls": 1,
              "eval": {"batch_size": 2, "brute_force": True, "vox_res": 16, "num_points": 200, "hier_final": False,
                       "bf_prune": None, "icp": False}},
    "train": {"runner": "train", "batch": 4, "pool_objects": 2, "views_per_object": 6, "sdf_points": 64,
              "drop_path": 0.1, "check_steps": 3, "max_steps": 16, "trace_steps": 1, "keep_within": 1},
}


RECON_NUMBERS = ("depth_gap", "intr_gap", "logit_gap", "sample_gap")
SCORE_NUMBERS = ("sample_gap", "search_gap", "gt_gap", "cd_gap", "fscore_gap")
TRAIN_NUMBERS = tuple(p + k for p in ("", "window_") for k in ("loss_gap", "grad_gap", "change_gap", "grad_gap_med", "change_gap_med"))


def make_root(tmp, cells, limits=1e9):
    """``tmp`` laid out as a checkout's root and the benchmark's folder:
    ``cells`` maps a cell name to ``(vit, mix)``. Returns the path."""
    tmp = Path(tmp)
    for d in ("configs", "traffic", "limits"):
        (tmp / d).mkdir(parents=True, exist_ok=True)
    bench = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
    bench = copy.deepcopy(bench)
    bench["configs"], bench["workloads"] = [], []
    for name, (vit, mix) in cells.items():
        cname = "tiny_vit" if vit else "tiny"
        if not any(c["name"] == cname for c in bench["configs"]):
            (tmp / "configs" / f"{cname}.json").write_text(json.dumps(tiny_config(vit)))
            bench["configs"].append({"name": cname, "source": "test", "file": f"configs/{cname}.json",
                                     "reduced": [], "why": "test"})
        (tmp / "traffic" / f"tiny_{mix}.json").write_text(json.dumps(MIXES[mix]))
        bench["workloads"].append({"name": name, "config": cname, "traffic": f"tiny_{mix}", "chips": 1,
                                   "why": "test"})
        keys = {"recon": RECON_NUMBERS, "score": RECON_NUMBERS + SCORE_NUMBERS, "train": TRAIN_NUMBERS}[mix]
        (tmp / "limits" / f"{name}.json").write_text(json.dumps({k: limits for k in keys}))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m:
                src = {"recon": "zeroshape.recon_b8", "score": "zeroshape.eval_final", "train": "zeroshape.train_b28"}[mix]
                if src in m["workloads"]:
                    m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
