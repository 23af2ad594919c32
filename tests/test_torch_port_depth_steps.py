"""Ten depth pretraining steps of the port against ``make_train_step`` (their
own file: the JAX step's compile is the slow part), and the depth loss on
the bf16 map the compute dtype gives it.

The depth graph at H=64 (full-width DPT and intrinsics head, as
``test_torch_port_depth_step.py`` builds it) under the ``depth_gen`` recipe
at its own lr 1e-4, from the recipe's own initial weights (``weights.
init_like_flax``: the head's last conv at 0.001 of its fan-in scale, bias
0.05), which reach JAX through the JAX importer; both packages take the
same ten distinct batches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from __graft_entry__ import _batch
from zeroshape_tpu.models import graph_depth as jgd
from zeroshape_tpu.parallel import train as jtrain
from zeroshape_tpu.runtime.checkpoint import convert_torch_state_dict
from zeroshape_tpu_torch import config, weights
from zeroshape_tpu_torch.models import graph_depth
from zeroshape_tpu_torch.losses import summarize_loss
from zeroshape_tpu_torch.models.graph_depth import DepthGraph
from zeroshape_tpu_torch.parallel import train as ptrain
from zeroshape_tpu_torch.weights import init_like_flax

from test_torch_harness import few_threads, give_memory_back  # noqa: F401 (autouse)

H, B, STEPS = 64, 2, 10
KEYS = ("rgb_input_map", "mask_input_map", "depth_input_map", "intr")
LOSSES = ("loss_all", "loss_depth", "loss_intr")


def _batches(n=STEPS, seed=11):
    """``n`` distinct batches of two images that differ in brightness and
    mask rate (flax's batch variance loses digits where samples are alike)."""
    out = []
    for i in range(n):
        b = {k: np.asarray(v) for k, v in _batch(B=B, H=H, n_pts=8, seed=seed + i).items() if k in KEYS}
        rng = np.random.default_rng(seed + 100 + i)
        keep = rng.permutation(np.linspace(0.3, 0.9, B))[:, None, None, None]
        b["mask_input_map"] = (rng.uniform(size=(B, H, H, 1)) < keep).astype(np.float32)
        b["rgb_input_map"] = (b["rgb_input_map"] * rng.permutation(np.linspace(0.3, 1.0, B))[:, None, None, None]
                              ).astype(np.float32)
        out.append(b)
    return out


def _recipe_start(opt, dtype=torch.float32):
    """The recipe's initial weights (``weights.init_like_flax`` at seed 0) as
    the port's graph and, copied, as JAX variables through the JAX importer."""
    port = init_like_flax(DepthGraph.from_opt(opt, dtype=dtype), 0)
    params, stats, report = convert_torch_state_dict({k: x.numpy().copy() for k, x in port.state_dict().items()},
                                                     graph="depth")
    assert report["missing"] == []
    return port, {"params": params, "batch_stats": stats}


def _head(kernel, bias):
    """The head's last conv (or its gradient) in the flax layout: torch
    ``[1, 32, 1, 1]`` -> ``[1, 1, 32, 1]``."""
    return {"kernel": kernel.detach().permute(2, 3, 1, 0).numpy().copy(), "bias": bias.detach().numpy().copy()}


def _free_run(opt, sd0, batches, threads):
    """The port's own ten steps from ``sd0`` on ``threads`` CPU threads: the
    losses and the head's last conv after each step."""
    n = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        port = weights.load(DepthGraph.from_opt(opt), sd0).train()
        optimizer = ptrain.make_optimizer(port, opt.optim)
        conv = port.dpt_depth.scratch.output_conv[4]
        rows = []
        for b in batches:
            metrics, _ = ptrain.train_step(port, optimizer, {k: torch.tensor(x) for k, x in b.items()}, opt,
                                           loss_fn=graph_depth.compute_loss, metrics_fn=None)
            rows.append(({k: float(v) for k, v in metrics.items()}, _head(conv.weight, conv.bias)))
        return rows
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """The JAX trajectory of ten steps; beside it the port's losses and head
    gradient at the JAX parameters and BatchNorm statistics of each step and
    its batch; and the port's own free runs on 2 and on 1 CPU threads. A JAX
    row holds the losses, the head's gradient, the head after the step and
    the whole gradient's norm."""
    opt = config.depth_gen_opt(H)
    assert opt.optim.lr == 1e-4 and not opt.optim.clip_norm and not opt.optim.sched
    batches = _batches()
    port, v = _recipe_start(opt)
    sd0 = {k: x.clone() for k, x in port.state_dict().items()}
    port.train()
    conv = port.dpt_depth.scratch.output_conv[4]

    mp = pytest.MonkeyPatch()
    stats_fn = fnn.normalization._compute_stats
    mp.setattr(fnn.normalization, "_compute_stats", lambda *a, **kw: stats_fn(*a, **dict(kw, use_fast_variance=False)))
    jax_rows, lock_rows = [], []
    try:
        jmodel = jgd.DepthGraph.from_opt(opt)
        # the JAX optimizer behind an identity stage that keeps the gradients
        # it passes on (as the one-step test does)
        keep_grads = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
        tx = optax.chain(keep_grads, jtrain.make_optimizer(v["params"], lr=opt.optim.lr,
                                                           weight_decay=opt.optim.weight_decay))
        state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
                                  opt_state=tx.init(v["params"]), tx=tx)
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
        step = jtrain.make_train_step(jmodel, opt, jgd.compute_loss, mesh)
        state = jax.device_put(state, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))  # one compile
        global_norm = jax.jit(optax.global_norm)
        for b in batches:
            with torch.no_grad():
                weights.load(port, weights.from_flax(jax.device_get(state.params), jax.device_get(state.batch_stats),
                                                     graph="depth"))
            batch = {k: torch.tensor(x) for k, x in b.items()}
            loss = graph_depth.compute_loss(opt, batch, port(batch, train=True), training=True)
            total = summarize_loss(loss, dict(opt.loss_weight))
            port.zero_grad(set_to_none=True)
            total.backward()
            lock_rows.append(({"loss_all": float(total), **{f"loss_{k}": float(x) for k, x in loss.items()}},
                              _head(conv.weight.grad, conv.bias.grad)))
            state, m = step(state, {k: jnp.asarray(x) for k, x in b.items()}, jax.random.PRNGKey(0))
            jax_rows.append(({k: float(x) for k, x in m.items()},
                             jax.device_get(state.opt_state[0]["dpt_depth"]["head_conv3"]),
                             jax.device_get(state.params["dpt_depth"]["head_conv3"]),
                             float(global_norm(state.opt_state[0]))))
        del state, step
    finally:
        mp.undo()
    del port
    return jax_rows, lock_rows, _free_run(opt, sd0, batches, 2), _free_run(opt, sd0, batches, 1)


def test_each_of_ten_depth_steps_is_the_jax_step(runs):
    """Each step, taken by the port from the JAX parameters of that step, is
    the one-step test's comparison: the three losses within 1e-5, and the
    gradient of the head's last conv (kernel, bias) within 1e-4 of the
    leaf's norm plus 1e-7 of the whole gradient's (the one-step test's
    bound; here no leaf needs its thread term)."""
    jax_rows, lock_rows, _, _ = runs
    assert len(jax_rows) == len(lock_rows) == STEPS
    for k, ((jloss, jgrad, _, whole), (ploss, pgrad)) in enumerate(zip(jax_rows, lock_rows)):
        assert set(jloss) == set(ploss) == set(LOSSES)
        for key in LOSSES:
            assert abs(ploss[key] - jloss[key]) <= 1e-5 * max(abs(jloss[key]), 1.0), (k, key, ploss[key], jloss[key])
        for key in ("kernel", "bias"):
            err = np.abs(pgrad[key] - jgrad[key]).max()
            assert err <= 1e-4 * np.linalg.norm(jgrad[key]) + 1e-7 * whole, (k, key, err)
        assert np.linalg.norm(jgrad["bias"]) > 0  # the head is alive


def test_ten_free_depth_steps_part_from_jax_no_more_than_from_themselves(runs):
    """Run free, the two packages' trajectories part after the first update,
    and the port's own runs on 1 and 2 CPU threads part by as much: AdamW's
    first update is +-lr for every element whatever its gradient's size, so
    rounding decides where the next steps start. After every step the
    port's losses lie within 1e-5 of JAX's plus 4x the largest distance
    between its own two runs so far (the one-step test's thread term, carried
    along the trajectory: two runs that have parted do not meet again), and
    the head's last conv within 1e-3 of lr a step plus 4x that distance."""
    jax_rows, _, two, one = runs
    lr = config.depth_gen_opt(H).optim.lr
    spread = {key: 0.0 for key in LOSSES + ("kernel", "bias")}
    parted = False
    for k, ((jloss, _, jhead, _), (ploss, phead), (sloss, shead)) in enumerate(zip(jax_rows, two, one)):
        for key in LOSSES:
            spread[key] = max(spread[key], abs(ploss[key] - sloss[key]))
            bound = 1e-5 * max(abs(jloss[key]), 1.0) + 4 * spread[key]
            assert abs(ploss[key] - jloss[key]) <= bound, (k, key, ploss[key], jloss[key], bound)
        for key in ("kernel", "bias"):
            spread[key] = max(spread[key], np.abs(phead[key] - shead[key]).max())
            err = np.abs(phead[key] - jhead[key]).max()
            assert err <= 1e-3 * lr * (k + 1) + 4 * spread[key], (k, key, err / lr, spread[key] / lr)
        parted |= abs(ploss["loss_all"] - sloss["loss_all"]) > 1e-3
    assert parted  # rounding alone parts the port's own runs


def test_the_depth_loss_takes_the_map_in_the_compute_dtype():
    """The JAX graph hands its loss the depth map in the compute dtype, bf16
    on the chip (``graph_depth.py:51``), so the median / MAD alignment and
    the inverse depth run on bf16 values there. The port's graph at bf16
    compute hands over the same dtype, and its loss of the map it gives
    matches the JAX loss of the same values within 1e-5 of itself (the same
    formulae on the same dtypes; their f32 sums differ in order only). The
    same map cast to fp32 first moves the loss by about 1e-3 of itself.
    The gradients with respect to the map are not compared: XLA rounds a
    fused chain of bf16 operations once and torch rounds each, which moves
    either form's gradient a few percent from JAX's."""
    opt = config.depth_gen_opt(H)
    depth_only = config.override_options(config.depth_gen_opt(H), {"loss_weight": {"intr": None}})
    b = {k: x[:1] for k, x in _batches(1)[0].items()}  # one image: bf16 convolutions are slow on the CPU
    port = _recipe_start(opt, dtype=torch.bfloat16)[0].eval()
    batch = {k: torch.tensor(x) for k, x in b.items()}
    with torch.no_grad():
        depth = port(batch, train=False)["depth_pred"]
    assert depth.dtype == torch.bfloat16

    jbatch = {k: jnp.asarray(x) for k, x in b.items()}
    jloss = lambda d: jgd.compute_loss(depth_only, jbatch, {"depth_pred": d}, training=True)["depth"]
    want = float(jloss(jnp.asarray(depth.float().numpy(), jnp.bfloat16)))

    def port_loss(d):
        d = d.detach().requires_grad_(True)
        got = graph_depth.compute_loss(depth_only, batch, {"depth_pred": d}, training=True)["depth"]
        got.backward()
        return float(got), d.grad.float().numpy()

    got, got_g = port_loss(depth)
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    assert np.isfinite(got_g).all() and np.linalg.norm(got_g) > 0
    cast, _ = port_loss(depth.float())
    assert abs(cast - want) > 1e-5 * abs(want)  # the difference the fp32 cast makes
