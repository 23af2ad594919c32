"""The training step: AdamW parameter groups, accumulation, clipping, one step
(counterpart of ``zeroshape_tpu/parallel/train.py``).

The reference's four AdamW groups, (finetune vs scratch) x (decay vs
nodecay), finetune being the DPT and the intrinsics head, become four
``torch.optim.AdamW`` groups (betas 0.9 / 0.95, eps 1e-8 as optax) inside
:class:`TrainOptimizer`, which also does what the JAX package chains around
its ``optax.multi_transform``:

* ``fix_dpt``: the finetune groups are frozen. Optax's ``set_to_zero``
  leaves them unchanged, while AdamW would still decay a parameter whose
  gradient is zero, so frozen parameters leave the optimizer and stop
  requiring gradients; their gradients then stay out of the global-norm
  clip, as ``:117-127`` makes sure in JAX.
* several ranks: before an update the gradients are averaged over the
  ranks (:func:`parallel.dist.average_gradients`, an explicit bucketed
  all-reduce), so the update is the one of the global batch, as the JAX
  package's single SPMD program computes it; BatchNorm's statistics are the
  global batch's (``models/layers.BatchNorm``) and stochastic depth keeps
  the global batch's masks (``make_drop_path_mask``). The graph is not
  wrapped in DDP: validation and the train-split metrics call its
  ``encode_image`` and decoder directly, and the ViT's last LayerNorm,
  which the DPT never reads, would need ``find_unused_parameters``.
* ``clip_norm``: the global-norm clip of ``optax.clip_by_global_norm``, of
  the averaged gradients.
* ``accum``: ``optax.MultiSteps``; the mean of ``accum`` mini-batch
  gradients is applied once.
* ``sched``: the per-epoch cosine, evaluated at the 0-based count of
  updates, with ``steps_per_epoch // accum`` updates an epoch (``:100-103``).
* without ``lr_ft`` (the depth recipes), the finetune groups take ``lr``,
  as ``:96`` does.

:func:`train_step` runs one mini-batch: forward, loss, backward, optimizer.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from zeroshape_tpu_torch.losses import summarize_loss
from zeroshape_tpu_torch.models.graph_shape import attn_geo_stats, compute_loss
from zeroshape_tpu_torch.parallel import dist

GROUPS = ("scratch_decay", "scratch_nodecay", "finetune_decay", "finetune_nodecay")


def param_group_labels(model):
    """``{parameter name: group}`` by the reference's rules (``train.py:47-67``):
    finetune is a name with a ``dpt_depth`` part or a part starting ``intr_``;
    nodecay is a parameter with at most one dimension or a name ending ``bias``."""
    labels = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        ft = any("dpt_depth" in k or k.startswith("intr_") for k in parts)
        nd = p.dim() <= 1 or name.endswith("bias")
        labels[name] = ("finetune_" if ft else "scratch_") + ("nodecay" if nd else "decay")
    return labels


def epoch_cosine_schedule(base_lr, max_epoch, steps_per_epoch):
    """Per-epoch cosine annealing (``train.py:70-78``) as a function of the
    update count, in float32 arithmetic as the JAX schedule computes it."""
    f32 = np.float32

    def sched(step):
        ep = min(step // max(steps_per_epoch, 1), max_epoch)
        return float(f32(0.5 * base_lr) * (f32(1.0) + np.cos(f32(np.pi) * f32(ep) / f32(max_epoch))))

    return sched


class TrainOptimizer:
    """AdamW over the four groups, with frozen groups, clip, accumulation and
    schedule as in ``make_optimizer`` (``train.py:81-130``). Gradients
    accumulate in ``.grad`` between mini-batches; :meth:`step` is called after
    every mini-batch's backward and applies an update on every
    ``accum``-th call, returning whether it did."""

    def __init__(self, model, lr, lr_ft=None, weight_decay=0.05, fix_dpt=False, clip_norm=None, accum=1,
                 sched=None):
        lr_ft = lr if lr_ft is None else lr_ft
        self.clip_norm, self.accum = clip_norm, max(int(accum or 1), 1)
        labels = param_group_labels(model)
        named = dict(model.named_parameters())
        base = {"scratch_decay": lr, "scratch_nodecay": lr, "finetune_decay": lr_ft, "finetune_nodecay": lr_ft}
        groups, self.names = [], []
        for g in GROUPS:
            names = [n for n, lab in labels.items() if lab == g]
            if fix_dpt and g.startswith("finetune_"):
                for n in names:
                    named[n].requires_grad_(False)
                continue
            decay = weight_decay if g.endswith("_decay") else 0.0
            groups.append({"params": [named[n] for n in names], "weight_decay": decay, "lr": base[g], "group": g})
            self.names += names
        self.adamw = torch.optim.AdamW(groups, betas=(0.9, 0.95), eps=1e-8)
        self.schedules = {}
        for group in self.adamw.param_groups:
            b = base[group["group"]]
            self.schedules[group["group"]] = (
                epoch_cosine_schedule(b, sched[0], max(1, sched[1] // self.accum)) if sched else (lambda _, b=b: b)
            )
        self.mini_step = 0  # mini-batches accumulated towards the next update
        self.updates = 0  # updates applied, the schedule's count

    def params(self):
        return [p for group in self.adamw.param_groups for p in group["params"]]

    def lr(self, group="scratch_decay"):
        """The learning rate of ``group`` at the next update."""
        return self.schedules[group](self.updates)

    def step(self):
        self.mini_step += 1
        if self.mini_step < self.accum:
            return False
        self.mini_step = 0
        grads = [p.grad for p in self.params() if p.grad is not None]
        dist.average_gradients(grads)  # each rank's mean over its rows -> the global batch's
        if self.accum > 1:
            torch._foreach_div_(grads, float(self.accum))
        if self.clip_norm:
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
            torch._foreach_mul_(grads, torch.where(norm < self.clip_norm, 1.0, self.clip_norm / norm))
        for group in self.adamw.param_groups:
            group["lr"] = self.schedules[group["group"]](self.updates)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.updates += 1
        return True

    def state_dict(self):
        """AdamW's state, the counters, and gradients accumulated towards the next update."""
        acc = {n: p.grad.clone() for n, p in zip(self.names, self.params()) if self.mini_step and p.grad is not None}
        return {"adamw": self.adamw.state_dict(), "mini_step": self.mini_step, "updates": self.updates,
                "acc_grads": acc}

    def load_state_dict(self, state):
        self.adamw.load_state_dict(state["adamw"])
        self.mini_step, self.updates = int(state["mini_step"]), int(state["updates"])
        for n, p in zip(self.names, self.params()):
            p.grad = state["acc_grads"][n].to(p.device) if n in state["acc_grads"] else None


def make_optimizer(model, optim, steps_per_epoch=None, max_epoch=None):
    """:class:`TrainOptimizer` from an ``optim`` option section (``train.py:133-158``)."""
    use_sched = optim.get("sched") and steps_per_epoch
    return TrainOptimizer(
        model,
        lr=optim.lr,
        lr_ft=optim.get("lr_ft"),
        weight_decay=optim.weight_decay,
        fix_dpt=optim.get("fix_dpt", False),
        clip_norm=optim.get("clip_norm"),
        accum=optim.get("accum", 1) or 1,
        sched=(max_epoch, steps_per_epoch) if use_sched else None,
    )


def capture_grads(model, optimizer):
    """Record the gradients that each ``optimizer.step()`` is handed.

    Returns a dict that every later step refills with ``{parameter name:
    gradient}``, copied before accumulation, clipping and the update; for
    holding one step's backward against a reference's.
    """
    grads, step = {}, optimizer.step

    def recording_step():
        grads.clear()
        grads.update({n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None})
        return step()

    optimizer.step = recording_step
    return grads


def batch_stats(model):
    """The BatchNorm running statistics, ``{name: tensor}`` (the JAX ``batch_stats``)."""
    return {n: b for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var"))}


def train_step(model, optimizer, batch, opt, generator=None, dp_masks=None, with_stats=False, loss_fn=compute_loss,
               metrics_fn=attn_geo_stats):
    """One training mini-batch (``make_train_step``, ``train.py:161-204``).

    ``model`` is a graph in train mode (a :class:`ShapeGraph`, or a
    ``DepthGraph`` with its own ``loss_fn`` and no ``metrics_fn``), ``batch``
    the JAX batch pytree as tensors on its device, ``generator`` the source
    of the shape decoder's stochastic depth (or ``dp_masks``, one ``[B]``
    mask per block; neither for the depth graph, which has none).
    ``loss_fn(opt, batch, out, training)`` gives the unweighted loss terms,
    ``metrics_fn(opt, batch, out)`` extra statistics, computed only
    ``with_stats``. Returns ``(metrics, batch_stats)``: ``loss_all`` and
    ``loss_{k}`` as device scalars (no host sync), with ``with_stats`` also
    ``metrics_fn``'s; the BatchNorm statistics are the model's, updated in
    place.
    """
    with record_function("train_forward"):
        given = generator is not None or dp_masks is not None
        stochastic_depth = {"generator": generator, "dp_masks": dp_masks} if given else {}
        out = model(batch, train=True, **stochastic_depth)
    with record_function("train_loss"):
        loss_dict = loss_fn(opt, batch, out, training=True)
        total = summarize_loss(loss_dict, dict(opt.loss_weight))
        extra = metrics_fn(opt, batch, out) if with_stats and metrics_fn else {}
    with record_function("train_backward"):
        total.backward()
    with record_function("optimizer_step"):
        optimizer.step()
    metrics = {"loss_all": total.detach()}
    metrics.update({f"loss_{k}": v.detach().mean() for k, v in loss_dict.items()})
    metrics.update(extra)
    return metrics, batch_stats(model)
