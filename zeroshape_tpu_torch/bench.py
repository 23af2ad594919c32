"""The headline benchmark and its companions (counterpart of ``bench.py``,
``scripts/bench_throughput.py`` and ``scripts/bench_ab.py``).

    python -m zeroshape_tpu_torch.bench [--seed=N]        # seconds a 128^3 reconstruction: one JSON line
    python -m zeroshape_tpu_torch.bench throughput [B ...] # images/s of the batched reconstruction (default 1 8)
    python -m zeroshape_tpu_torch.bench ab [reps]          # K1 against the plain decode, interleaved in one process
    python -m zeroshape_tpu_torch.bench eval               # seconds a sample of shape_engine.evaluate, both postures

The headline measures the whole inference pipeline of one image on the
card: DPT depth and intrinsics, the visible-surface encoding, the
coarse-to-fine occupancy decode at vox 128 through the fused decoder (K1,
two launches) and 10k area-uniform surface samples. It warms up once, times
``BENCH_REPS`` (9) reconstructions on the host clock, each ending in a
sync, and prints, last, ``{"metric": "shape_recon_latency_vox128", "value":
s/image, "unit": "s/image", "vs_baseline": 1 / value}``: ``vs_baseline`` is
the speed-up over the north-star target of 1 s an image. A line before it
names the card and its power limit, K1's launches a reconstruction and the
active coarse cells.

Weights: a trained checkpoint where one is found (:func:`_find_ckpt`:
``BENCH_CKPT``, else the port's ``output/shape/{shape_overfit,
shape_gen_staged,shape_gen}/best.ckpt``), read strictly, at sharpen 1, on a
real sample of the analytic tree where one is on disk (:func:`_real_sample`:
``BENCH_DATA``, else ``/tmp/overfit_data``, else ``/tmp/gen_data``);
otherwise ``recon.synthetic_setup``'s seeded random weights, calibrated to a
trained field's active cells, at sharpen 25, on its synthetic image.

Every measurement runs on the card and raises without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from zeroshape_tpu_torch import recon, resolve_device

BASELINE_SECONDS = 1.0  # the north-star target: under 1 s an image at vox 128
CAPACITY = recon.CAPACITY
COUNTED = ("K1", "K2", "K3", "plain")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CKPT_CANDIDATES = [
    os.path.join(_REPO, "output/shape/shape_overfit/best.ckpt"),
    os.path.join(_REPO, "output/shape/shape_gen_staged/best.ckpt"),
    os.path.join(_REPO, "output/shape/shape_gen/best.ckpt"),
]


def launch_counts():
    """The kernels' launch counts and the plain decodes of decoders K1 does not take."""
    from zeroshape_tpu_torch.ops.chamfer import nn_min_squared_fast, nn_one_way
    from zeroshape_tpu_torch.ops.implicit_kernel import fused_decode

    return {"K1": fused_decode.launches, "K2": nn_one_way.launches, "K3": nn_min_squared_fast.launches,
            "plain": recon.decode_points.plain_decodes}


def reset_counts():
    from zeroshape_tpu_torch.ops.chamfer import nn_min_squared_fast, nn_one_way
    from zeroshape_tpu_torch.ops.implicit_kernel import fused_decode

    fused_decode.launches = nn_one_way.launches = nn_min_squared_fast.launches = 0
    recon.decode_points.plain_decodes = 0


def card():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _find_ckpt():
    """``BENCH_CKPT`` where set, else the first of the trained runs' ``best.ckpt``
    files that exists; None without one."""
    env = os.environ.get("BENCH_CKPT")
    for path in [env] if env else _CKPT_CANDIDATES:
        if path and os.path.isfile(path):
            return path
    return None


def _tree_root():
    """The analytic tree :func:`_real_sample` reads (``BENCH_DATA``, else
    ``/tmp/overfit_data``, else ``/tmp/gen_data``); None without one."""
    for root in (os.environ.get("BENCH_DATA", "/tmp/overfit_data"), "/tmp/gen_data"):
        if os.path.isdir(os.path.join(root, "train_data")):
            return root
    return None


def _real_sample(H):
    """The first training view of the analytic tree (``BENCH_DATA``, else
    ``/tmp/overfit_data``, else ``/tmp/gen_data``) at ``H``^2: numpy
    ``rgb_input_map [1, H, H, 3]`` and ``mask_input_map [1, H, H, 1]``;
    None where no tree is on disk."""
    from zeroshape_tpu_torch.config import Config
    from zeroshape_tpu_torch.data.synthetic import Dataset

    root = _tree_root()
    if root is None:
        return None
    opt = Config({"H": H, "W": H, "image_size": [H, H], "seed": 0,
                  "data": {"root": root, "bgcolor": 1, "num_workers": 0, "num_classes_test": 15, "max_img_cat": None,
                           "dataset_train": "synthetic", "dataset_test": "synthetic",
                           "synthetic": {"subset": "analytic", "percentage": 1}},
                  "training": {"n_sdf_points": 16}})
    s = Dataset(opt, split="train", load_3D=False)[0]
    return {"rgb_input_map": s["rgb_input_map"][None], "mask_input_map": s["mask_input_map"][None]}


def variant(model, use_fused):
    """``model``'s graph decoding through K1 (``use_fused``) or plainly in its
    compute dtype; the weights are shared."""
    return recon.ReconModel(model.graph, None, model.sharpen, model.device, fused=use_fused).repack()


def build(use_fused=None, device=None, ckpt=None, opt=None, seed=0):
    """``(reconstruct, model, batch)`` of the headline (``bench.py:94-213``).

    ``reconstruct(model, batch, generator)`` is ``recon.reconstruct`` at vox
    128, capacity 4096 and 10k points. ``use_fused`` None decodes through K1
    where it is built for the decoder; False decodes with the plain
    ``Implicit.decode`` (the A/B's and the FLOP count's counterpart). ``ckpt``
    None looks for a trained checkpoint (:func:`_find_ckpt`); with one, its
    weights at sharpen 1 on :func:`_real_sample` (or the synthetic image),
    else :func:`recon.synthetic_setup`'s calibrated random weights and its
    image drawn from ``seed``. ``opt`` another architecture than the
    shipped one.
    """
    from zeroshape_tpu_torch.config import synthetic_image
    from zeroshape_tpu_torch.runtime import checkpoint

    ckpt = ckpt or _find_ckpt()
    if ckpt:
        model = recon.build(opt, device=device)
        meta = checkpoint.apply_weights(model.graph, checkpoint.load_reference_ckpt(ckpt), strict=True, path=ckpt)
        model.sharpen = 1.0  # a trained field is already saturated
        batch = _real_sample(model.graph.H)
        real = batch is not None
        if batch is None:
            rgb, mask = synthetic_image(model.graph.H, seed=seed)
            batch = {"rgb_input_map": rgb, "mask_input_map": mask}
        tree = f"the first training view of {_tree_root()}" if real else "the synthetic image (no tree on disk)"
        print(f"bench: trained weights from {ckpt} (epoch {meta.get('epoch')}), input {tree}", file=sys.stderr)
    else:
        model, batch, _, _ = recon.synthetic_setup(device, opt=opt, seed=seed)
    if use_fused is not None:
        model = variant(model, use_fused)
    else:
        model.repack()
    return recon.reconstruct, model, batch


def host_seconds(fn, reps):
    """Host-clock seconds of ``reps`` calls of ``fn()``, each ending in a sync."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def latency(seed=0):
    """The headline: prints the card line and the JSON line; returns the JSON's dict."""
    dev = resolve_device(None)
    reconstruct, model, batch = build(device=dev, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    reset_counts()
    world, depth, intr, n_active = reconstruct(model, batch, gen)
    torch.cuda.synchronize()
    k1 = launch_counts()["K1"]
    n_act = int(n_active.max())
    if n_act > CAPACITY:
        print(f"WARNING: hier decode active cells ({n_act}) exceed capacity ({CAPACITY}); surface may be "
              "under-refined", file=sys.stderr)
    reps = int(os.environ.get("BENCH_REPS", "9"))
    times = host_seconds(lambda: reconstruct(model, batch, gen), reps)
    value = float(np.median(times))
    q1, q3 = np.percentile(times, [25, 75])
    print(f"bench: median {value * 1e3:.1f} ms over {reps} reps, IQR [{q1 * 1e3:.1f}, {q3 * 1e3:.1f}] ms, "
          f"min {min(times) * 1e3:.1f} / max {max(times) * 1e3:.1f}", file=sys.stderr)
    print(f"bench: card {card()}; K1 launches a reconstruction {k1}; n_active {n_act} / capacity {CAPACITY}; "
          f"seed {seed}")
    line = {"metric": "shape_recon_latency_vox128", "value": round(value, 4), "unit": "s/image",
            "vs_baseline": round(BASELINE_SECONDS / value, 3)}
    print(json.dumps(line), flush=True)
    return line


def throughput(sizes=(1, 8)):
    """Images/s of ``recon.reconstruct_batch`` (coarse-to-fine, vox 128, 10k
    points an image) on B copies of the sample, ``BENCH_REPS`` (7) reps a
    size; K1 must launch twice a call (the coarse and the fine pass of the
    whole batch)."""
    dev = resolve_device(None)
    _, model, one = build(device=dev)
    reps = int(os.environ.get("BENCH_REPS", "7"))
    results = {}
    for B in sizes:
        batch = {k: np.repeat(np.asarray(v), B, axis=0) for k, v in one.items()}
        gens = [torch.Generator(device=dev).manual_seed(b) for b in range(B)]
        t0 = time.perf_counter()
        recon.reconstruct_batch(model, batch, gens)
        torch.cuda.synchronize()
        print(f"B={B}: warm-up {time.perf_counter() - t0:.1f} s", file=sys.stderr)
        reset_counts()
        times = host_seconds(lambda: recon.reconstruct_batch(model, batch, gens), reps)
        k1 = launch_counts()["K1"] / reps
        if k1 != 2:
            raise RuntimeError(f"B={B}: K1 launched {k1} times a call, expected 2")
        med = float(np.median(times))
        results[B] = {"s_per_batch": med, "img_per_s": B / med, "k1_per_call": k1}
        print(f"B={B}: median {med * 1e3:.1f} ms/batch = {med / B * 1e3:.1f} ms/image = {B / med:.1f} img/s "
              f"(min {min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f}); K1 {k1:g} a call", flush=True)
    for B, r in results.items():
        if B != 1 and 1 in results:
            print(f"B={B} vs B=1: {r['img_per_s'] / results[1]['img_per_s']:.2f}x throughput", flush=True)
    print(f"bench throughput: card {card()}")
    print(json.dumps({"metric": "shape_recon_throughput_vox128", "unit": "img/s",
                      "sizes": {str(B): r for B, r in results.items()}}), flush=True)
    return results


def ab(reps=8):
    """The K1 path and the plain-decode path of one model, timed interleaved
    rep by rep in this process (``scripts/bench_ab.py``): each variant's
    median and the ratio of the medians, each pair's ratio and its spread."""
    dev = resolve_device(None)
    reconstruct, fused, batch = build(use_fused=True, device=dev)
    variants = {"fused": fused, "plain": variant(fused, use_fused=False)}
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, model in variants.items():
        reset_counts()
        t0 = time.perf_counter()
        reconstruct(model, batch, gen)
        torch.cuda.synchronize()
        n = launch_counts()
        want = {"fused": (2, 0), "plain": (0, 2)}[name]
        if (n["K1"], n["plain"]) != want:
            raise RuntimeError(f"{name}: K1 {n['K1']}, plain {n['plain']} a reconstruction, expected {want}")
        print(f"{name}: warm-up {time.perf_counter() - t0:.1f} s; K1 {n['K1']}, plain decodes {n['plain']}",
              flush=True)
    times = {name: [] for name in variants}
    for _ in range(reps):
        for name, model in variants.items():
            t0 = time.perf_counter()
            reconstruct(model, batch, gen)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    for name, ts in times.items():
        print(f"{name}: median {np.median(ts) * 1e3:.1f} ms  min {min(ts) * 1e3:.1f}  max {max(ts) * 1e3:.1f}",
              flush=True)
    pairs = np.asarray(times["fused"]) / np.asarray(times["plain"])
    ratio = float(np.median(times["fused"]) / np.median(times["plain"]))
    print(f"fused/plain: {ratio:.3f} (medians); pairs {[round(float(p), 3) for p in pairs]}, median "
          f"{np.median(pairs):.3f}, min {pairs.min():.3f}, max {pairs.max():.3f}")
    print(f"bench ab: card {card()}")
    out = {"metric": "shape_recon_ab_vox128", "unit": "s/image", "reps": reps,
           "median": {n: float(np.median(ts)) for n, ts in times.items()}, "ratio": ratio,
           "pair_ratios": pairs.tolist()}
    print(json.dumps(out), flush=True)
    return out


EVAL_BATCH = 2  # the eval batch size of evaluate_posture


def expected_launches(n_samples, training, batch_size=EVAL_BATCH):
    """The launches ``shape_engine.evaluate`` of the shipped decoder implies
    with brute force on ``n_samples`` in batches of ``batch_size`` (the
    loader pads the last): final posture K1 1 (the dense grid) and K2 288
    (the exhaustive search) a batch; validation K1 2 (coarse-to-fine), K3 72
    and K2 6 (the pruned search) a batch; never a plain decode."""
    k = -(-n_samples // batch_size)
    if training:
        return {"K1": 2 * k, "K2": 6 * k, "K3": 72 * k, "plain": 0}
    return {"K1": k, "K2": 288 * k, "K3": 0, "plain": 0}


def evaluate_posture(model, samples, training, output_path):
    """One ``shape_engine.evaluate`` of ``samples`` at vox 128, eval batch 2 (:data:`EVAL_BATCH`),
    brute force on, in the validation (``training``) or final posture, its
    files in ``output_path``. Returns ``(result, opt, launches, seconds)``:
    the launches counted from 0, the host-clock seconds ending in a sync."""
    from zeroshape_tpu_torch.config import eval_opt, full_opt
    from zeroshape_tpu_torch.runtime import shape_engine

    opt = eval_opt(full_opt(), vox_res=recon.VOX_RES, brute_force=True, batch_size=EVAL_BATCH)
    reset_counts()
    t0 = time.perf_counter()
    res = shape_engine.evaluate(model, samples, opt, output_path, ["prim"], training=training, device=model.device)
    recon.sync(model.device)
    return res, opt, launch_counts(), time.perf_counter() - t0


def evaluation():
    """Seconds a sample of ``shape_engine.evaluate`` on ``analytic.eval_samples(4,
    2, 224)`` in the final and the validation posture, with launches a sample."""
    from zeroshape_tpu_torch.data import analytic

    dev = resolve_device(None)
    _, model, _ = build(device=dev)
    samples = analytic.eval_samples(n_objects=4, n_views=2, H=224, seed=0)
    out = {}
    for training in (False, True):
        name = "validation" if training else "final"
        with tempfile.TemporaryDirectory() as tmp:
            res, _, n, seconds = evaluate_posture(model, samples, training, tmp)
        if n != expected_launches(len(samples), training):
            raise RuntimeError(f"{name} posture launched {n}, expected {expected_launches(len(samples), training)}")
        out[name] = {"s_per_sample": seconds / len(samples), "cd": res["val_metric"],
                     "launches_per_sample": {k: v / len(samples) for k, v in n.items()}}
        print(f"{name} posture: {seconds / len(samples):.4f} s/sample over {len(samples)} samples, CD "
              f"{res['val_metric']:.6f}, launches {n}", flush=True)
    print(f"bench eval: card {card()}")
    print(json.dumps({"metric": "shape_eval_seconds_per_sample_vox128", "unit": "s/sample", **out}), flush=True)
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    resolve_device(None)  # every measurement needs the card
    cmd, rest = (argv[0], argv[1:]) if argv and not argv[0].startswith("--") else ("latency", argv)
    if cmd == "latency":
        flags = dict(a[2:].split("=", 1) for a in rest if a.startswith("--") and "=" in a)
        return latency(int(flags.get("seed", 0)))
    if cmd == "throughput":
        return throughput([int(a) for a in rest] or [1, 8])
    if cmd == "ab":
        return ab(int(rest[0]) if rest else 8)
    if cmd == "eval":
        return evaluation()
    raise SystemExit(f"unknown command {cmd!r}: latency (the default), throughput, ab or eval")


if __name__ == "__main__":
    main()
