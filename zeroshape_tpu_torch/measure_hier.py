"""Active-cell demand of the coarse-to-fine decode on trained fields
(counterpart of ``scripts/measure_hier.py``).

    python -m zeroshape_tpu_torch.measure_hier [--task=shape | --yaml=options/shape_gen.yaml] \\
        --name=shape_gen_staged --resume [--extra_ckpts=output/shape/shape_gen/best.ckpt,...] [--device=cpu]

Loads the run's ``best.ckpt`` (``--resume``; or ``--ckpt``) into one graph,
reconstructs every sample of the test split in the validation posture
(``recon.reconstruct_batch`` with the hierarchical decode at
``eval.vox_res``, capacity ``eval.hier_capacity``) and prints each batch's
``n_active``: the coarse cells the margin test marks, counted before the
capacity clamp. Each checkpoint of ``--extra_ckpts`` is then swapped into
the same graph (``checkpoint.load_weights``) and measured likewise. Last,
for each, the distribution (min, median, p95, max) and how many samples
would overflow a capacity of 2048, 4096 and the engine's default
(``eval3d.resolve_hier_capacity``), in the JAX script's lines.

The options are the train CLI's, unchecked, with ``eval.n_vis`` 0 and
``eval.hier_decode`` on. Where the hierarchical decode would not run
(``vox_res`` not a multiple of 4, or a capacity at which the dense decode is
cheaper) it raises instead of measuring the dense one, which has no count.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from zeroshape_tpu_torch import recon, resolve_device
from zeroshape_tpu_torch.config import parse_arguments
from zeroshape_tpu_torch.data.base import DataLoader
from zeroshape_tpu_torch.evaluate import graph_for
from zeroshape_tpu_torch.metrics.eval3d import resolve_hier_capacity
from zeroshape_tpu_torch.runtime import checkpoint, engine_base, shape_engine
from zeroshape_tpu_torch.train import options

CAPACITIES = (2048, 4096)


def measure(model, data, opt, label):
    """``n_active`` of every sample of ``data`` (numpy ``[N]``), one line a batch."""
    ev = opt.eval
    if not shape_engine.use_hier_decode(opt, training=True):
        raise RuntimeError(f"the hierarchical decode does not run at vox_res {ev.vox_res}, capacity "
                           f"{ev.get('hier_capacity')}: the dense decode has no active-cell count")
    loader = DataLoader(data, ev.batch_size, num_workers=(opt.get("data") or {}).get("num_workers", 4))
    counts = []
    for it, batch in enumerate(loader):
        B0 = min(ev.batch_size, len(data) - it * ev.batch_size)
        gens = shape_engine.sample_generators(batch["idx"], model.device)
        _, _, _, n_active = recon.reconstruct_batch(model, batch, gens, ev.vox_res, ev.get("hier_capacity"),
                                                    ev.num_points, tuple(ev.range), hier=True)
        got = n_active.cpu().numpy()[:B0].tolist()
        counts.extend(got)
        print(f"[{label}] batch {it}: n_active {got}", flush=True)
    return np.asarray(counts, np.int64)


def report(counts, vox, label):
    """The JAX script's summary lines of ``counts`` (also printed)."""
    default_cap = resolve_hier_capacity(vox, None)
    lines = [f"\n[{label}] vox_res={vox}, coarse cells={(vox // 4) ** 3}, engine default capacity={default_cap}",
             f"[{label}] samples: {len(counts)}",
             f"[{label}] n_active: min={counts.min()} median={int(np.median(counts))} "
             f"p95={int(np.percentile(counts, 95))} max={counts.max()}"]
    for cap in CAPACITIES + (default_cap,):
        lines.append(f"[{label}]   capacity {cap}: {int((counts > cap).sum())}/{len(counts)} samples would overflow")
    print("\n".join(lines))
    return lines


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    extra = [p for p in str(parse_arguments(argv).get("extra_ckpts") or "").split(",") if p]
    opt = options([a for a in argv if not a.startswith("--extra_ckpts")], safe_check=False)
    opt.eval.n_vis = 0
    opt.eval.hier_decode = True
    dev = resolve_device(opt.get("device"))
    _, data = engine_base.load_dataset(opt, eval_split="test", load_train=False)
    model = recon.ReconModel(graph_for(opt, dev), None, 1.0, dev).repack()
    label = opt.get("name") or "main"
    results = [(label, measure(model, data, opt, label))]
    for path in extra:
        lab = os.path.basename(os.path.dirname(path)) or path
        print(f"\nswapping weights to {path}", flush=True)
        checkpoint.load_weights(model.graph, path)
        model.repack()
        results.append((lab, measure(model, data, opt, lab)))
    for lab, counts in results:
        report(counts, opt.eval.vox_res, lab)
    return dict(results)


if __name__ == "__main__":
    main()
