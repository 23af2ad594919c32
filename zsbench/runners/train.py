"""Training at the published batch: ``parallel/train.train_step`` with the
port's ``TrainOptimizer`` (AdamW over its four groups), bf16 compute, on
batches of seeded analytic training views held on the device.

Set-up makes the weights from the seed on the device, loads them into the
port's graph in train mode, builds the optimizer from the configuration's
``optim`` section, renders the pool (each row its own draw of SDF samples),
and drives the step through its first ``check_steps`` steps with the
window's own call, on rows that all differ. From those it reads each step's
loss, the first gradient as the optimizer got it (AdamW's first moment after
one step over 1 - beta1) and the parameters' change after the last checked
step. The window then continues the same object: steps dispatched ahead
without a per-step sync, the window ending in one. Stochastic depth takes
masks drawn from the seed, handed to the step and to the reference alike.
One step of the window, drawn from the seed, is kept as well (in a traced
run, the step after the traced window): the parameters and AdamW's moments
just before it, its batch and masks, its loss, and the parameters and first
moment just after it.

The check runs the reference (float32, TF32 off, plain AdamW) once the
window has closed and the program's state is freed: through the checked
steps on the same rows and masks from the seed's weights, and through the
kept window step from the program's own parameters and moments before it
(the only way to follow the program that far; the start of that path is
what the checked steps compare).
"""

import contextlib
import time

import numpy as np
import torch

from zsbench import program, scenes, work
from zsbench.reference.init import build_reference
from zsbench.reference.precision import exact_fp32
from zsbench.runners import sync

BATCH_KEYS = ("rgb_input_map", "mask_input_map", "depth_input_map", "intr", "pose_gt", "gt_sample_points",
              "gt_sample_sdf")


def group_of(name, p):
    """The reference's AdamW groups (``train.py:47-67``): finetune is a name
    with a ``dpt_depth`` part or a part starting ``intr_``; nodecay a
    parameter of at most one dimension or a name ending ``bias``."""
    ft = any("dpt_depth" in k or k.startswith("intr_") for k in name.split("."))
    return ("finetune_" if ft else "scratch_") + ("nodecay" if p.dim() <= 1 or name.endswith("bias") else "decay")


class PlainAdamW:
    """Decoupled-weight-decay Adam over named parameters."""

    def __init__(self, named, lr, lr_ft, weight_decay, betas=(0.9, 0.95), eps=1e-8):
        self.named, self.betas, self.eps, self.t = named, betas, eps, 0
        self.hyper = {n: ((lr_ft if group_of(n, p).startswith("finetune") else lr),
                          (weight_decay if group_of(n, p).endswith("_decay") else 0.0)) for n, p in named.items()}
        self.m = {n: torch.zeros_like(p) for n, p in named.items()}
        self.v = {n: torch.zeros_like(p) for n, p in named.items()}

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = self.betas
        for n, p in self.named.items():
            if p.grad is None:
                continue
            lr, wd = self.hyper[n]
            g = p.grad
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            p.mul_(1 - lr * wd)
            denom = (self.v[n] / (1 - b2**self.t)).sqrt() + self.eps
            p.add_(self.m[n] / (1 - b1**self.t) / denom, alpha=-lr)
            p.grad = None


class Runner:
    def __init__(self, cfg, mix, seed, device):
        self.opts, self.mix, self.seed, self.device = cfg["options"], mix, seed, device
        self.B = mix["batch"]

    # -- set-up -----------------------------------------------------------
    def setup(self):
        m, dev = self.mix, self.device
        self.pool = scenes.make_pool(self.seed, self.opts["H"], m["pool_objects"], m["views_per_object"], dev,
                                     sdf_points=m["sdf_points"])
        with exact_fp32():
            ref = build_reference(self.opts, self.seed, dev)
        state = {k: v.detach().clone() for k, v in ref.reference_state().items()}
        del ref
        self.blocks = self.block_counts()
        self.opt = program.options(self.opts)
        self.graph = program.build_graph(self.opt, state, dev, train=True)
        del state
        self.optimizer = program.make_optimizer(self.graph, self.opt)
        self.optimizer_betas = self.optimizer.adamw.param_groups[0]["betas"]
        n_rows = self.pool["rgb_input_map"].shape[0]
        if n_rows < m["check_steps"] * self.B:
            raise ValueError("the pool holds fewer rows than the checked steps take")
        self.order = scenes.draw_order(self.seed, n_rows, m["max_steps"], self.B)
        self.mask_gen = torch.Generator(device=dev).manual_seed(self.seed)
        self.kept_draw = float(np.random.default_rng(self.seed).random())
        self.steps, self.masks, self.kept_at, self.kept = 0, [], None, None
        self.read_first_steps()

    def block_counts(self):
        arch = self.opts["arch"]
        counts = {"impl_network": arch["impl"]["att_blocks"]}
        if arch["depth"]["encoder"] == "transformer":
            counts["coord_encoder"] = arch["depth"]["n_blocks"]
        if arch["rgb"]["encoder"] == "transformer":
            counts["rgb_encoder"] = arch["rgb"]["n_blocks"]
        return counts

    def draw_masks(self):
        """One step's stochastic-depth masks by module, in the order the modules
        run: a mask a decoder block, a pair a transformer encoder block."""
        keep = 1.0 - self.mix["drop_path"]
        draw = lambda: (torch.rand(self.B, generator=self.mask_gen, device=self.device) < keep).float() / keep  # noqa: E731
        masks = {}
        for mod in ("rgb_encoder", "coord_encoder"):
            if mod in self.blocks:
                masks[mod] = [(draw(), draw()) for _ in range(self.blocks[mod])]
        masks["impl_network"] = [draw() for _ in range(self.blocks["impl_network"])]
        return masks

    def batch(self, s):
        idx = torch.as_tensor(self.order[s % len(self.order)], device=self.device)
        return {k: self.pool[k][idx] for k in BATCH_KEYS}

    # -- the timed path -----------------------------------------------------
    def step(self):
        masks = self.draw_masks()
        if self.steps < self.mix["check_steps"]:
            self.masks.append(masks)
        keep = self.steps == self.kept_at
        if keep:
            self.kept = dict(self.state(moments=True), masks=masks)
        metrics, _ = program.train_step(self.graph, self.optimizer, self.batch(self.steps), self.opt, dp_masks=masks)
        if keep:
            after = self.state(moments=False)
            self.kept.update(loss=metrics["loss_all"], params_after=after["params"], exp_avg_after=after["exp_avg"])
        self.steps += 1
        return metrics["loss_all"]

    def state(self, moments):
        """Copies of the parameters by name, AdamW's first moments (and with
        ``moments`` its second moments and step count), queued on the device."""
        opt = self.optimizer.adamw.state
        named = dict(self.graph.named_parameters())
        out = {"params": {n: p.detach().clone() for n, p in named.items()},
               "exp_avg": {n: opt[p]["exp_avg"].clone() for n, p in named.items() if p in opt}}
        if moments:
            out["exp_avg_sq"] = {n: opt[p]["exp_avg_sq"].clone() for n, p in named.items() if p in opt}
            steps = {float(opt[p]["step"]) for p in named.values() if p in opt} or {0.0}
            if len(steps) != 1:
                raise ValueError(f"AdamW's leaves are at different steps: {sorted(steps)}")
            out["t"] = int(steps.pop())
        return out

    def keep_within(self, span):
        """Keep one of the next ``span`` steps, drawn from the seed."""
        self.kept_at = self.steps + int(self.kept_draw * span)

    def read_first_steps(self):
        """Drive the first ``check_steps`` steps and keep what the check compares."""
        named = dict(self.graph.named_parameters())
        start = {n: p.detach().clone() for n, p in named.items()}
        bn0 = bn_means(self.graph)
        self.losses, self.grad_norms = [], {}
        for i in range(self.mix["check_steps"]):
            self.losses.append(float(self.step()))
            if i == 0:
                self.bn_change = {n: b - bn0[n] for n, b in bn_means(self.graph).items()}
                beta1 = self.optimizer_betas[0]
                state = self.optimizer.adamw.state
                self.grad_norms = {n: float(state[p]["exp_avg"].norm() / (1 - beta1))
                                   for n, p in named.items() if p in state and "exp_avg" in state[p]}
        self.change_norms = {n: float((p.detach() - start[n]).norm()) for n, p in named.items()}
        del start

    def window(self, seconds):
        self.keep_within(self.mix["keep_within"])
        losses = []
        sync(self.device)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            losses.append(self.step())
        sync(self.device)
        elapsed = time.perf_counter() - t0
        steps = len(losses)
        while self.steps <= self.kept_at:  # a window too short for its kept step runs on to it, off the clock
            losses.append(self.step())
        self.window_losses = torch.stack(losses)
        return {"train_img_per_s": self.B * steps / elapsed}, steps

    def traced_units(self):
        n = self.mix["trace_steps"]
        self.window_losses = torch.stack([self.step() for _ in range(n)])
        return n

    def after_trace(self):
        """The step after the traced window, kept: its copies of the state stay
        out of the trace's kernels and idle time."""
        self.keep_within(1)
        self.window_losses = torch.cat([self.window_losses, self.step()[None]])

    def failed(self):
        """Steps of the window whose loss is not finite."""
        return int((~torch.isfinite(self.window_losses)).sum())

    def release(self):
        del self.graph, self.optimizer

    # -- the check ----------------------------------------------------------
    def reference_steps(self, control=None, rows=None):
        """The reference's loss a step, first gradient's norm a leaf, change
        a leaf after the checked steps and the change of each BatchNorm's
        running mean in the first step, on the program's rows and masks;
        ``control`` (a context) runs it under that context, ``rows`` keeps
        only the first rows of each batch (the mean over the rest)."""
        o = self.opts
        with exact_fp32():
            ref = build_reference(o, self.seed, self.device).train()
            named = dict(ref.reference_state_params())
            start = {n: p.detach().clone() for n, p in named.items()}
            adamw = PlainAdamW(named, o["optim"]["lr"], o["optim"]["lr_ft"], o["optim"]["weight_decay"])
            bn0 = bn_means(ref)
            losses, grads = [], {}
            for i in range(self.mix["check_steps"]):
                loss, g = self.reference_step(ref, named, adamw, self.batch(i), self.masks[i], control, rows)
                losses.append(loss)
                if i == 0:
                    grads, bn = g, {n: b - bn0[n] for n, b in bn_means(ref).items()}
            change = {n: float((p.detach() - start[n]).norm()) for n, p in named.items()}
        return losses, grads, change, bn

    def reference_step(self, ref, named, adamw, batch, masks, control, rows):
        """One step of the reference: its loss and each leaf's gradient norm."""
        if rows is not None:
            batch = {k: v[:rows] for k, v in batch.items()}
            masks = {k: [tuple(x[:rows] for x in m) if isinstance(m, tuple) else m[:rows] for m in ms]
                     for k, ms in masks.items()}
        sl = self.opts["training"]["shape_loss"]
        with (control or contextlib.nullcontext)():
            loss = ref.train_loss(batch, masks, sl["impt_thres"], sl["impt_weight"])
            loss.backward()
        grads = {n: float(p.grad.norm()) for n, p in named.items() if p.grad is not None}
        adamw.step()
        return float(loss.detach()), grads

    def reference_window(self, control=None, rows=None):
        """The reference through the kept window step, from the program's
        parameters and AdamW moments just before it."""
        k, o = self.kept, self.opts
        with exact_fp32():
            ref = build_reference(o, self.seed, self.device).train()
            named = dict(ref.reference_state_params())
            with torch.no_grad():
                for n, p in named.items():
                    p.copy_(k["params"][n].float())
            adamw = PlainAdamW(named, o["optim"]["lr"], o["optim"]["lr_ft"], o["optim"]["weight_decay"])
            adamw.t = k["t"]
            for n in k["exp_avg"]:  # leaves that have had a gradient
                adamw.m[n].copy_(k["exp_avg"][n].float())
                adamw.v[n].copy_(k["exp_avg_sq"][n].float())
            loss, grads = self.reference_step(ref, named, adamw, self.batch(self.kept_at), k["masks"], control, rows)
            change = {n: float((p.detach() - k["params"][n].float()).norm()) for n, p in named.items()}
        return [loss], grads, change

    def program_window(self):
        """The program's kept window step: its loss, each leaf's gradient as
        AdamW got it (from the first moment before and after), its change."""
        k = self.kept
        beta1 = self.optimizer_betas[0]
        grads = {n: float(((k["exp_avg_after"][n] - beta1 * m).float() / (1 - beta1)).norm())
                 for n, m in k["exp_avg"].items()}
        change = {n: float((k["params_after"][n].float() - p.float()).norm()) for n, p in k["params"].items()}
        return [float(k["loss"])], grads, change

    def check(self, control=None, fault=None):
        """The compared numbers of the checked steps and (``window_``) of the
        kept window step; ``control`` (a context) puts the reference under it
        in the program's place; ``fault`` is ``half_batch`` (the reference on
        half of each batch in the program's place) or ``unchanged`` (no
        parameter moves)."""
        ref, ref_w = self.reference_steps(), self.reference_window()
        rows = self.B // 2 if fault == "half_batch" else None
        if control is not None or rows is not None:
            got, got_w = self.reference_steps(control, rows), self.reference_window(control, rows)
        else:
            got, got_w = (self.losses, self.grad_norms, self.change_norms, self.bn_change), self.program_window()
            if fault == "unchanged":
                got, got_w = (got[0], got[1], dict.fromkeys(got[2], 0.0), got[3]), (got_w[0], got_w[1],
                                                                                     dict.fromkeys(got_w[2], 0.0))
        numbers, first = compare(ref[:3], got[:3])
        window, last = compare(ref_w, got_w)
        self.details = {"checked_steps": first, "window_step": dict(last, step=self.kept_at)}
        numbers.update({f"window_{k}": v for k, v in window.items()})
        if ref[3]:  # a model with BatchNorm
            numbers["bn_mean_gap_med"] = bn_gap(ref[3], got[3])
        return numbers

    # -- work for the per-layer metrics ---------------------------------------
    def layer_context(self, summary, units):
        o = self.opts
        with exact_fp32():
            ref = build_reference(o, self.seed, self.device).train()
            sl = o["training"]["shape_loss"]

            def fwd_bwd():
                ref.train_loss(self.batch(0), self.masks[0], sl["impt_thres"], sl["impt_weight"]).backward()

            flops, _ = work.count_flops(fwd_bwd)
        del ref
        return {"images": self.B * units, "steps": units, "step_flops": flops}


def bn_means(model):
    """Copies of the BatchNorm running means by name (a model without BatchNorm: none)."""
    return {n: b.detach().float().clone() for n, b in model.named_buffers() if n.endswith("running_mean")}


def bn_gap(ref, got):
    """The median over BatchNorm layers of the relative gap between the
    program's and the reference's change of the running mean in the first
    step: a gap in the forward pass's batch means (a layer missing on the
    program's side, or not finite, is a gap of 1 or more)."""
    gaps = []
    for n, r in ref.items():
        g = float((got[n] - r).norm() / r.norm()) if n in got else 1.0
        gaps.append(g if g == g else float("inf"))
    return sorted(gaps)[len(gaps) // 2]


def compare(ref, got, tiny=1e-3):
    """The compared numbers and their details: the widest relative gap of a
    step's loss; and, by the worst leaf and by the median leaf, the gap
    between the program's and the reference's norm of the first gradient and
    of the change after the checked steps, over the reference's norm of that
    leaf or of the median leaf, whichever is larger. The median leaf is taken
    over the leaves whose reference gradient is not zero (a part of the
    network that the loss no longer reaches, such as a depth head that has
    died, passes none); leaves under ``tiny`` of its gradient (nought to
    rounding) are left out of both. A norm that is not finite, or a step with
    no leaf to compare, reads as an infinite gap."""
    (l_r, g_r, d_r), (l_p, g_p, d_p) = ref, got
    inf = float("inf")
    fin = lambda v: v if v == v else inf  # noqa: E731

    def rel(a, b, scale):
        return 0.0 if a == b else fin(abs(a - b) / scale) if scale > 0 else inf

    loss_gap = max(rel(a, b, abs(b)) for a, b in zip(l_p, l_r))
    positive = sorted(v for v in g_r.values() if v == v and v > 0)
    g_med = positive[len(positive) // 2] if positive else inf
    leaves = [n for n, v in g_r.items() if not v == v or v >= tiny * g_med]
    dfin = sorted(d_r[n] for n in leaves if d_r[n] == d_r[n])
    d_med = dfin[len(dfin) // 2] if dfin else inf
    g = {n: rel(g_p.get(n, 0.0), g_r[n], max(g_r[n], g_med)) for n in leaves}
    d = {n: rel(d_p.get(n, 0.0), d_r[n], max(d_r[n], d_med)) for n in leaves}
    med = lambda x: sorted(x.values())[len(x) // 2] if x else inf  # noqa: E731
    top = lambda x: max(x.values()) if x else inf  # noqa: E731
    details = {"losses_ref": l_r, "losses_got": l_p, "leaves": len(leaves), "all": len(g_r),
               "zero_grad_ref": len(g_r) - len(positive),
               "nan_ref": [n for n, v in g_r.items() if v != v][:5],
               "nan_got": [n for n, v in g_p.items() if v != v][:5]}
    for name, gaps in (("grad", g), ("change", d)):
        details[name] = sorted(gaps.items(), key=lambda kv: -kv[1])[:8]
    return {"loss_gap": loss_gap, "grad_gap": top(g), "change_gap": top(d),
            "grad_gap_med": med(g), "change_gap_med": med(d)}, details
