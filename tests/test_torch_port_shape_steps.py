"""Shape steps of the port on one fixed batch against ``make_train_step`` (their
own file: the JAX step's trace and compile are the slow part).

The steps of ``chip_smoke.py``'s overfit check, on a graph the CPU can
afford: the tiny shape graph of ``test_torch_port_train.py`` (``_tiny_opt``:
the full-width DPT over a narrow decoder) with every loss at the
``shape_gen`` weights (shape 1, depth 1, intr 10) and the ``shape_gen``
optimizer (AdamW over the four groups at lr = lr_ft = 1e-4, no clip, no
schedule), numpy-random weights with the depth head inside its clamp, and
every decoder block kept. Both packages take STEPS steps on one fixed batch,
each continuing its own optimizer.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from __graft_entry__ import _batch, _tiny_opt
from zeroshape_tpu.models.graph_shape import ShapeGraph as JShapeGraph
from zeroshape_tpu.models.graph_shape import compute_loss as j_compute_loss
from zeroshape_tpu.models.implicit import Implicit as JImplicit
from zeroshape_tpu.parallel import train as jtrain
from zeroshape_tpu.runtime.checkpoint import convert_torch_state_dict
from zeroshape_tpu_torch import config, weights
from zeroshape_tpu_torch.losses import summarize_loss
from zeroshape_tpu_torch.models.graph_shape import ShapeGraph, compute_loss
from zeroshape_tpu_torch.parallel import train as ptrain

from test_torch_harness import few_threads, give_memory_back  # noqa: F401 (autouse)

H, B, STEPS = 32, 4, 3
N_MLP_LINEARS = 5  # tiny_opt: 4 hidden linears + the output
LOSSES = ("loss_all", "loss_shape", "loss_depth", "loss_intr")
LEAVES = ("dpt_depth.scratch.output_conv.4.weight", "impl_network.impl_mlp.layers.4.weight")


def _options():
    """``_tiny_opt(H)`` with ``shape_gen``'s loss weights and optimizer."""
    opt = _tiny_opt(H)
    recipe = config.shape_gen_opt(H)
    assert not recipe.optim.get("clip_norm") and not recipe.optim.get("sched") and recipe.optim.lr == 1e-4
    opt.loss_weight = dict(recipe.loss_weight)
    opt.optim.lr, opt.optim.lr_ft = recipe.optim.lr, recipe.optim.lr_ft
    opt.optim.weight_decay = recipe.optim.weight_decay
    return opt


def _fixed_batch(seed=5):
    """``_batch`` whose samples differ in brightness and mask rate (flax's
    batch variance loses digits where samples are alike)."""
    b = {k: np.asarray(v) for k, v in _batch(B=B, H=H, n_pts=64, seed=seed).items()}
    rng = np.random.default_rng(seed + 1)
    keep = np.linspace(0.2, 0.9, B)[:, None, None, None]
    b["mask_input_map"] = (rng.uniform(size=(B, H, H, 1)) < keep).astype(np.float32)
    b["rgb_input_map"] = (b["rgb_input_map"] * np.linspace(0.3, 1.0, B)[:, None, None, None]).astype(np.float32)
    return b


def _start(port, seed=2):
    """Numpy-random weights as the parity tests draw them (parameters and
    running means N(0, 0.05), running variances U(0.6, 1.4)), the depth
    head's last conv scaled into its [0, 1] clamp with spread (a live depth
    loss); returns them as the port's state dict and as JAX variables."""
    rng = np.random.default_rng(seed)
    sd = port.state_dict()
    names = set(dict(port.named_parameters())) | {k for k in sd if k.endswith("running_mean")}
    for k, x in sd.items():
        if k in names:
            sd[k] = torch.from_numpy(rng.standard_normal(x.shape, np.float32) * np.float32(0.05))
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.6, 1.4, x.shape).astype(np.float32))
    sd["dpt_depth.scratch.output_conv.4.weight"] *= 1e-2
    sd["dpt_depth.scratch.output_conv.4.bias"].fill_(0.5)
    params, stats, report = convert_torch_state_dict({k: x.numpy() for k, x in sd.items()}, graph="shape",
                                                     impl_mlp_linears=N_MLP_LINEARS)
    assert report["missing"] == []
    return sd, {"params": params, "batch_stats": stats}


def _free_run(opt, sd0, batch, masks, threads):
    """The port's own STEPS steps from ``sd0`` on ``threads`` CPU threads:
    the losses and the LEAVES after each step."""
    n = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        port = weights.load(ShapeGraph.from_opt(config.tiny_opt(H)), sd0).train()
        optimizer = ptrain.make_optimizer(port, opt.optim)
        params = dict(port.named_parameters())
        rows = []
        for _ in range(STEPS):
            metrics, _ = ptrain.train_step(port, optimizer, batch, opt, dp_masks=masks)
            rows.append(({k: float(v) for k, v in metrics.items()},
                         {k: params[k].detach().numpy().copy() for k in LEAVES}))
        return rows
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """The JAX trajectory of STEPS steps (its losses, each step's gradient by
    port name, the LEAVES after each step); beside it the port's losses and
    gradients at the JAX parameters and BatchNorm statistics of each step;
    and the port's own free runs on 2 and on 1 CPU threads, taken while the
    JAX step compiles."""
    opt = _options()
    popt = config.Config(opt)
    b = _fixed_batch()
    batch = {k: torch.tensor(x) for k, x in b.items()}
    port = ShapeGraph.from_opt(config.tiny_opt(H))
    sd0, v = _start(port)
    weights.load(port, sd0).train()
    masks = [torch.full((B,), 1 / (1 - port.impl_network.drop_path)) for _ in port.impl_network.blocks_attn]

    def inject(next_fun, args, kwargs, context):
        if isinstance(context.module, JImplicit) and context.method_name == "_dp_masks":
            return [jnp.asarray(m.numpy()) for m in masks]
        return next_fun(*args, **kwargs)

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    jbatch = {k: jnp.asarray(x) for k, x in b.items()}
    jax_step = {}

    def compile_step():  # XLA's compile leaves the interpreter to the free runs
        # the JAX optimizer behind an identity stage that keeps the gradients
        # it passes on (as the one-step test does)
        keep = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
        tx = optax.chain(keep, jtrain.make_optimizer(v["params"], lr=opt.optim.lr, lr_ft=opt.optim.lr_ft,
                                                     weight_decay=opt.optim.weight_decay))
        state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
                                  opt_state=tx.init(v["params"]), tx=tx)
        state = jax.device_put(state, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
        with fnn.intercept_methods(inject):
            step = jtrain.make_train_step(JShapeGraph.from_opt(opt), opt, j_compute_loss, mesh)
            jax_step.update(state=state, step=step.lower(state, jbatch, jax.random.PRNGKey(0)).compile())

    mp = pytest.MonkeyPatch()
    stats_fn = fnn.normalization._compute_stats
    mp.setattr(fnn.normalization, "_compute_stats", lambda *a, **kw: stats_fn(*a, **dict(kw, use_fast_variance=False)))
    try:
        worker = threading.Thread(target=compile_step)
        worker.start()
        free = _free_run(popt, sd0, batch, masks, 2), _free_run(popt, sd0, batch, masks, 1)
        worker.join()
    finally:
        mp.undo()
    assert "step" in jax_step, "the JAX step did not compile"
    state = jax_step["state"]

    to_port = lambda tree: weights.from_flax(tree, jax.device_get(state.batch_stats),  # noqa: E731
                                             impl_mlp_linears=N_MLP_LINEARS)
    params = dict(port.named_parameters())
    current = to_port(jax.device_get(state.params))
    jax_rows, lock_rows = [], []
    for _ in range(STEPS):
        with torch.no_grad():
            weights.load(port, current)
        loss = compute_loss(popt, batch, port(batch, train=True, dp_masks=masks), training=True)
        total = summarize_loss(loss, dict(popt.loss_weight))
        port.zero_grad(set_to_none=True)
        total.backward()
        got = {"loss_all": float(total.detach()), **{f"loss_{k}": float(x.detach()) for k, x in loss.items()}}
        lock_rows.append((got, {k: p.grad.numpy().copy() for k, p in params.items() if p.grad is not None}))
        state, m = jax_step["step"](state, jbatch, jax.random.PRNGKey(0))
        grads, current = to_port(jax.device_get(state.opt_state[0])), to_port(jax.device_get(state.params))
        jax_rows.append(({k: float(x) for k, x in m.items()}, {k: grads[k].numpy() for k in params if k in grads},
                         {k: current[k].numpy().copy() for k in LEAVES}))
    return jax_rows, lock_rows, *free


def test_each_shape_step_on_one_batch_is_the_jax_step(runs):
    """Each step, taken by the port from the JAX parameters and statistics of
    that step, is the one-step test's comparison: the four losses within
    1e-5, and each gradient leaf within 1e-4 of the leaf's norm plus 1e-7 of
    the whole gradient's."""
    jax_rows, lock_rows, _, _ = runs
    assert len(jax_rows) == len(lock_rows) == STEPS
    for k, ((jloss, jgrad, _), (ploss, pgrad)) in enumerate(zip(jax_rows, lock_rows)):
        assert set(jloss) == set(ploss) == set(LOSSES)
        for key in LOSSES:
            assert abs(ploss[key] - jloss[key]) <= 1e-5 * max(abs(jloss[key]), 1.0), (k, key, ploss[key], jloss[key])
        norms = {n: float(np.linalg.norm(g)) for n, g in jgrad.items()}
        whole = np.sqrt(sum(x**2 for x in norms.values()))
        errs = {n: float(np.abs(pgrad[n] - g).max()) if n in pgrad else norms[n] for n, g in jgrad.items()}
        bad = {n: e / norms[n] for n, e in errs.items() if e > 1e-4 * norms[n] + 1e-7 * whole}
        assert not bad, (k, bad)
        assert sum(x > 0 for x in norms.values()) > 400  # every encoder and the head take part


def test_free_shape_steps_on_one_batch_part_from_jax_no_more_than_from_themselves(runs):
    """Run free, each package continuing its own optimizer, the port's losses
    lie within 1e-5 of JAX's plus 4x the largest distance between its own
    runs on 2 and 1 CPU threads so far, and the LEAVES (the depth head's last
    conv, the decoder's output linear) within 1e-3 of lr a step plus 4x that
    distance: rounding, not the port, is what parts them."""
    jax_rows, _, two, one = runs
    lr = _options().optim.lr
    spread = {key: 0.0 for key in LOSSES + LEAVES}
    for k, ((jloss, _, jleaf), (ploss, pleaf), (sloss, sleaf)) in enumerate(zip(jax_rows, two, one)):
        for key in LOSSES:
            spread[key] = max(spread[key], abs(ploss[key] - sloss[key]))
            bound = 1e-5 * max(abs(jloss[key]), 1.0) + 4 * spread[key]
            assert abs(ploss[key] - jloss[key]) <= bound, (k, key, ploss[key], jloss[key], bound)
        for key in LEAVES:
            spread[key] = max(spread[key], np.abs(pleaf[key] - sleaf[key]).max())
            err = np.abs(pleaf[key] - jleaf[key]).max()
            assert err <= 1e-3 * lr * (k + 1) + 4 * spread[key], (k, key, err / lr, spread[key] / lr)
