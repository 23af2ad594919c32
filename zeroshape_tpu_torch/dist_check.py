"""One training step and one evaluation of a shape graph, in one process or
several, so that the two can be compared; then, where asked, the train CLI
on the same ranks.

    python -m zeroshape_tpu_torch.dist_check OUT [--full] [--device=cpu] [--threads=N] [train ARGS...]
    python -m torch.distributed.run --standalone --nproc_per_node=2 -m zeroshape_tpu_torch.dist_check OUT ...

The graph is ``config.tiny_opt(32)`` or, with ``--full``, the shipped shape
model of ``config.shape_gen_opt()`` at 224^2 with its 4096 SDF points, in
fp32 (TF32 off on the card, as ``resolve_device`` sets it) with every loss weighted as in
``shape_gen``; weights drawn with numpy from a seed (parameters and running
means N(0, 0.05), running variances U(0.6, 1.4)) so every BatchNorm and
encoder gets a gradient; a random global batch of 4 samples that differ in
brightness and mask rate, each rank taking its rows; stochastic depth from
``shape_engine.step_generator(0, 0)``. Rank 0 writes ``OUT/step.pt``: the
gradients the update applied (averaged over the ranks), the BatchNorm
running statistics after the step, and the loss averaged over the ranks.

Then the stepped graph evaluates 5 analytic test samples
(``data.analytic.eval_samples``) at eval batch 2, an uneven tail, in the
final posture at vox 16 through ``shape_engine.evaluate``: rank 0 writes the
result files into ``OUT`` and the per-sample metrics to ``OUT/eval.pt``.
With ``train`` and the train CLI's arguments after it, the same ranks then
run ``python -m zeroshape_tpu_torch.train`` with them (one launch for both),
and rank 0 writes the run's losses, validations and steps to
``OUT/train.pt``.

A run of N ranks should give what one rank gives, up to the order of sums
(:func:`disagreements`). On random weights the fp32 step is ill-conditioned:
train-mode BatchNorm deep in the coordinate encoder's ResNet amplifies
rounding (a relative difference of ~3e-6 in its input map becomes ~1e-3 at
its output and up to ~7e-2 of a gradient leaf's norm), whatever the image
size, batch or images; so the comparison allows 4x the step's own spread
under a change of arithmetic alone (another CPU thread count, or the CPU
against the card) where that exceeds the tolerance. Before the step,
:func:`parts` runs pieces of the graph in which rounding is not amplified,
to be held with no such allowance; rank 0 writes them to ``OUT/parts.pt``.
"""

from __future__ import annotations

import copy
import os
import sys

import numpy as np
import torch

from zeroshape_tpu_torch import config, recon, resolve_device
from zeroshape_tpu_torch.data import analytic
from zeroshape_tpu_torch.models.graph_shape import ShapeGraph
from zeroshape_tpu_torch.parallel import dist
from zeroshape_tpu_torch.parallel import train as ptrain
from zeroshape_tpu_torch.runtime import shape_engine

B, SEED = 4, 2


def case(device, full=False):
    """``(opt, graph, global batch)`` of the step, the graph on ``device``:
    the tiny graph at 32^2 with 64 SDF points, or (``full``) the shipped one."""
    if full:
        opt = config.eval_opt(config.shape_gen_opt(), batch_size=2, vox_res=16, num_points=300)
    else:
        opt = config.eval_opt(config.tiny_opt(32), batch_size=2, vox_res=16, num_points=300)
        opt.loss_weight = {"shape": 1, "depth": 1, "intr": 10}
        opt.training.n_sdf_points = 64
    opt.arch.dtype = "float32"
    opt.optim.lr = opt.optim.lr_ft = 1e-2
    opt.data.num_workers = 2
    H, n_pts = opt.H, opt.training.n_sdf_points
    graph = ShapeGraph.from_opt(opt)
    rng = np.random.default_rng(SEED)
    params = dict(graph.named_parameters())
    with torch.no_grad():
        for k, t in graph.state_dict().items():
            if k.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.uniform(0.6, 1.4, t.shape).astype(np.float32)))
            elif k in params or k.endswith("running_mean"):
                t.copy_(torch.from_numpy(rng.normal(0.0, 0.05, t.shape).astype(np.float32)))
        head = graph.dpt_depth.scratch.output_conv[4]  # into the depth head's clamp
        head.weight.mul_(1e-2)
        head.bias.fill_(0.5)
    f = 1.3875 * H
    K = np.array([[f, 0, H / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    batch = {
        "rgb_input_map": rng.uniform(0, 1, (B, H, H, 3)) * np.linspace(0.3, 1.0, B)[:, None, None, None],
        "mask_input_map": rng.uniform(size=(B, H, H, 1)) < np.linspace(0.2, 0.9, B)[:, None, None, None],
        "depth_input_map": rng.uniform(0.4, 1, (B, H, H, 1)),
        "intr": np.tile(K, (B, 1, 1)),
        "pose_gt": np.tile(np.concatenate([np.eye(3), [[0.0], [0.0], [1.78]]], axis=1), (B, 1, 1)),
        "gt_sample_points": rng.normal(size=(B, n_pts, 3)) * 0.3,
        "gt_sample_sdf": rng.normal(size=(B, n_pts)) * 0.05,
    }
    return opt, graph.to(device).train(), {k: torch.tensor(np.asarray(v, np.float32)) for k, v in batch.items()}


def step(opt, graph, batch, device):
    """This rank's rows of the step; ``{"grads", "bn", "loss"}`` on the CPU."""
    local = dist.local_batch(B)
    rows = {k: v[dist.rank() * local: (dist.rank() + 1) * local].to(device) for k, v in batch.items()}
    optimizer = ptrain.make_optimizer(graph, opt.optim)
    applied, adamw_step = {}, optimizer.adamw.step

    def recording_step(*args, **kwargs):  # the gradients the update applies
        applied.update({n: p.grad.detach().cpu().clone() for n, p in graph.named_parameters() if p.grad is not None})
        return adamw_step(*args, **kwargs)

    optimizer.adamw.step = recording_step
    metrics, stats = ptrain.train_step(graph, optimizer, rows, opt, shape_engine.step_generator(0, 0, device))
    loss = dist.mean_over_ranks({"loss": float(metrics["loss_all"])})["loss"]
    return {"grads": applied, "bn": {k: v.detach().cpu().clone() for k, v in stats.items()}, "loss": loss}


def parts(graph, device):
    """Three pieces of the step in which rounding is not amplified, each a
    copy of the graph's module in training mode on this rank's rows of a
    global batch of ``B`` drawn with numpy: ``intr_head`` (two conv-BatchNorm
    bottlenecks, statistics over the batch alone) on ``[B, 768, 4, 4]``,
    ``coord_encoder.encoder.layer1`` (three ResNet bottlenecks) on ``[B, 64,
    8, 8]``, and ``impl_network`` (the decoder, stochastic depth from
    ``step_generator(0, 0)``) on random latents and 64 points a sample. The
    loss is the global batch's mean of the output against fixed random
    weights, the gradients averaged over the ranks as in a step. Returns
    ``{name: {"out": the output's rows of every rank, "grads", "bn"}}``."""
    rng = np.random.default_rng(SEED + 1)
    latent = graph.impl_network.latent_proj.weight.shape[1]
    tokens = graph.impl_network.pos_embed.shape[1]
    cases = {
        "intr_head": (graph.intr_head, [rng.normal(size=(B, 768, 4, 4))]),
        "coord_encoder.encoder.layer1": (graph.coord_encoder.encoder.layer1, [rng.normal(size=(B, 64, 8, 8))]),
        "impl_network": (graph.impl_network, [rng.normal(size=(B, tokens, latent)), rng.normal(size=(B, 64, 3)) * 0.3]),
    }
    local, r = dist.local_batch(B), dist.rank()
    got = {}
    for name, (module, inputs) in cases.items():
        module = copy.deepcopy(module).to(device).train()
        xs = [torch.tensor(x[r * local: (r + 1) * local], dtype=torch.float32, device=device) for x in inputs]
        if name == "impl_network":
            module.drop_path = 0.5
            out = module(xs[0], None, xs[1], True, shape_engine.step_generator(0, 0, device))[0]
        else:
            out = module(*xs)
        w = torch.tensor(rng.normal(size=(B,) + tuple(out.shape[1:]))[r * local: (r + 1) * local],
                         dtype=torch.float32, device=device)
        (out * w).sum().div(local).backward()
        named = [(k, p) for k, p in module.named_parameters() if p.grad is not None]
        dist.average_gradients([p.grad for _, p in named])
        got[name] = {"out": dist.gather_rows({"out": out.detach().cpu().numpy()})["out"],
                     "grads": {k: p.grad.detach().cpu().clone() for k, p in named},
                     "bn": {k: v.detach().cpu().clone() for k, v in module.state_dict().items() if "running" in k}}
    return got


def disagreements(ref, got, spread=None, tol=1e-5, bn_tol=1e-6, tol_total=1e-7):
    """Where the step ``got`` (:func:`step`'s dict) is off ``ref``: the gradient
    leaves with ``|got - ref| > tol * |ref| + tol_total * |ref's whole
    gradient|`` (the parity tests' bound, ``tests/test_torch_port_train.py``),
    and the BatchNorm statistics with ``max |got - ref| > bn_tol``, each
    bound raised to 4x the difference between ``ref`` and ``spread`` (the
    same step at another thread count) where that is larger. Returns ``(bad
    gradient leaves, bad statistics, the share of leaves within tol * |ref|
    alone, the largest |got - ref| / |ref|)``."""
    bad, bad_bn, within, worst = [], [], 0, 0.0
    total = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in ref["grads"].values()])))
    for k, g in ref["grads"].items():
        d, n = float((got["grads"][k] - g).norm()), float(g.norm())
        own = 4 * float((spread["grads"][k] - g).norm()) if spread else 0.0
        within += d <= tol * n
        worst = max(worst, d / max(n, 1e-30))
        if d > max(tol * n + tol_total * total, own) or set(got["grads"]) != set(ref["grads"]):
            bad.append(k)
    for k, v in ref["bn"].items():
        own = 4 * float((spread["bn"][k] - v).abs().max()) if spread else 0.0
        if float((got["bn"][k] - v).abs().max()) > max(bn_tol, own):
            bad_bn.append(k)
    return bad, bad_bn, within / max(len(ref["grads"]), 1), worst


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    own, train_args = (argv[:argv.index("train")], argv[argv.index("train") + 1:]) if "train" in argv else (argv, None)
    flags = dict(a[2:].split("=", 1) if "=" in a else (a[2:], True) for a in own[1:] if a.startswith("--"))
    threads = torch.get_num_threads()
    torch.set_num_threads(int(flags.get("threads", threads)))
    try:
        _run(own[0], flags.get("device"), bool(flags.get("full")), train_args)
    finally:
        torch.set_num_threads(threads)


def _run(out, device, full, train_args):
    dist.init_distributed_from_env()
    dev = resolve_device(device)
    os.makedirs(out, exist_ok=True)
    opt, graph, batch = case(dev, full)
    pieces = parts(graph, dev)
    res = step(opt, graph, batch, dev)
    if dist.is_main():
        torch.save(res, os.path.join(out, "step.pt"))
        torch.save(pieces, os.path.join(out, "parts.pt"))
    graph.eval()
    model = recon.ReconModel(graph, None, 1.0, dev).repack()
    samples = analytic.eval_samples(n_objects=5, n_views=2, H=opt.H, seed=0, n_pc_points=300, n_sdf_points=300)
    got = shape_engine.evaluate(model, samples, opt, out, ["prim"], training=False, device=dev)
    if dist.is_main():
        torch.save({k: torch.as_tensor(np.asarray(got[k])) for k in ("acc", "comp", "f_score", "idx", "val_metric")},
                   os.path.join(out, "eval.pt"))
    print(f"rank {dist.rank()} of {dist.world()}: loss {res['loss']:.6f}, CD {got['val_metric']:.6f}", flush=True)
    del model, graph
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if train_args is not None:
        from zeroshape_tpu_torch import train

        run = train.main(train_args)
        if dist.is_main():
            torch.save({"losses": run["losses"], "val": run["val"], "it": run["it"]}, os.path.join(out, "train.pt"))
    if dist.initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
