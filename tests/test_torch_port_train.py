"""The port's training step against ``zeroshape_tpu.parallel.train``.

* the parameter groups are the JAX partition, through the weight map;
* the optimizer (AdamW groups, schedule, accumulation, clip, frozen DPT)
  applies the updates that the optax chain applies, fed the same gradients;
* one full train step of the tiny shape graph (H=64, batch 4, lr 1e-2)
  matches ``make_train_step`` on the same variables and batch: losses and
  attention statistics 1e-5, each parameter's gradient 1e-4 of its norm,
  updated parameters and BatchNorm statistics 1e-4.

Both sides get the same stochastic depth: an interceptor around
``Implicit._dp_masks`` hands the JAX decoder fixed masks (with dropped
samples, so both paths of the residual are exercised), and the port gets the
same masks as ``dp_masks``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn
from flax import linen as fnn

from __graft_entry__ import _batch, _tiny_opt
from zeroshape_tpu.models.graph_shape import ShapeGraph as JShapeGraph
from zeroshape_tpu.models.graph_shape import attn_geo_stats as j_attn_geo_stats
from zeroshape_tpu.models.graph_shape import compute_loss as j_compute_loss
from zeroshape_tpu.models.implicit import Implicit as JImplicit
from zeroshape_tpu.parallel import train as jtrain
from zeroshape_tpu.runtime.checkpoint import convert_torch_state_dict
from zeroshape_tpu_torch import config, weights
from zeroshape_tpu_torch.models.graph_shape import ShapeGraph
from zeroshape_tpu_torch.parallel import train as ptrain

from test_torch_harness import close, random_variables
from test_torch_harness import give_memory_back  # noqa: F401 (autouse: frees the module's memory at its end)

H_STEP = 64  # the full step's size: every map of the encoders at least 2x2
N_MLP_LINEARS = 5  # tiny_opt: 4 hidden linears + the output


@pytest.fixture(scope="module")
def jax_graph():
    """The tiny JAX graph (every loss weighted), a batch and random variables."""
    opt = _tiny_opt(H_STEP)
    opt.loss_weight = {"shape": 1, "depth": 1, "intr": 10}  # every loss term, the shape_gen weights
    jmodel = JShapeGraph.from_opt(opt)
    jbatch = _step_batch()
    v = random_variables(jmodel, jbatch, train=False, seed=2)
    _tame_depth_head(v)
    return opt, jmodel, jbatch, v


def test_param_group_labels_match_jax(jax_graph):
    _, _, _, v = jax_graph
    jlabels = dict(jax.tree_util.tree_flatten_with_path(jtrain.param_group_labels(v["params"]))[0])
    labels = ptrain.param_group_labels(ShapeGraph.from_opt(config.tiny_opt(H_STEP)))
    seen = set()
    for key, coll, path, _ in weights.map_shape_graph(impl_mlp_linears=N_MLP_LINEARS):
        if coll == "params":
            jpath = tuple(jax.tree_util.DictKey(k) for k in path)
            assert labels[key] == jlabels[jpath], key
            seen.add(key)
    # the one unmapped parameter set: refinenet4's first unit, never executed
    rest = set(labels) - seen
    assert rest and all("refinenet4.resConfUnit1." in k and labels[k].startswith("finetune_") for k in rest)
    assert {lab for lab in labels.values()} == set(ptrain.GROUPS)


class _Toy(nn.Module):
    """One parameter set of each group."""

    def __init__(self):
        super().__init__()
        self.dpt_depth = nn.Linear(4, 3)
        self.intr_proj = nn.Linear(3, 2)
        self.decoder = nn.Linear(5, 4)
        self.norm = nn.LayerNorm(4)


def _toy_pair(seed=0):
    """The toy module and its JAX tree (the same arrays, elementwise updates
    need no transposes)."""
    torch.manual_seed(seed)
    toy = _Toy()
    tree = {}
    for name, p in toy.named_parameters():
        mod, leaf = name.split(".")
        tree.setdefault(mod, {})["kernel" if leaf == "weight" and p.dim() == 2 else leaf] = p.detach().numpy().copy()
    return toy, tree


def _jax_leaf(tree, name):
    mod, leaf = name.split(".")
    return tree[mod]["kernel" if leaf == "weight" and leaf not in tree[mod] else leaf]


OPTIM_CASES = {
    "groups": dict(lr=1e-2, lr_ft=1e-3, weight_decay=0.05),
    "schedule": dict(lr=1e-2, lr_ft=3e-3, weight_decay=0.05, sched=(3, 4)),
    "schedule_accum2": dict(lr=1e-2, lr_ft=3e-3, weight_decay=0.05, sched=(3, 4), accum=2),
    "clip": dict(lr=1e-2, weight_decay=0.05, clip_norm=0.5),
    "fix_dpt_clip": dict(lr=1e-2, weight_decay=0.05, fix_dpt=True, clip_norm=0.5),
    "accum2": dict(lr=1e-2, lr_ft=1e-3, weight_decay=0.05, accum=2),
}


@pytest.mark.parametrize("case", sorted(OPTIM_CASES))
def test_optimizer_matches_optax(case):
    """Fed the same gradients, the port's optimizer and the JAX optax chain
    hold the same parameters after every mini-batch (14 of them)."""
    kw = OPTIM_CASES[case]
    toy, tree = _toy_pair()
    opt = ptrain.TrainOptimizer(toy, **kw)
    tx = jtrain.make_optimizer(tree, **kw)
    state = tx.init(tree)
    update = jax.jit(tx.update)
    params = jax.tree.map(jnp.asarray, tree)
    frozen = {n: p.detach().clone() for n, p in toy.named_parameters() if n.startswith(("dpt_depth", "intr_"))}
    rng = np.random.default_rng(1)
    for step in range(14):
        grads = {n: rng.normal(0, 2.0, p.shape).astype(np.float32) for n, p in toy.named_parameters()}
        for n, p in toy.named_parameters():
            if p.requires_grad:  # what backward would accumulate
                g = torch.tensor(grads[n])
                p.grad = g if p.grad is None else p.grad + g
        applied = opt.step()
        jgrads = jax.tree.map(jnp.zeros_like, params)
        for n in grads:
            mod, leaf = n.split(".")
            jleaf = "kernel" if "kernel" in jgrads[mod] and leaf == "weight" else leaf
            jgrads[mod][jleaf] = jnp.asarray(grads[n])
        updates, state = update(jgrads, state, params)
        params = optax.apply_updates(params, updates)
        assert applied == ((step + 1) % kw.get("accum", 1) == 0)
        for n, p in toy.named_parameters():
            close(p.detach().numpy(), _jax_leaf(params, n), 1e-5, f"{case}: {n} after mini-batch {step}")
    if kw.get("fix_dpt"):
        for n, before in frozen.items():
            assert torch.equal(dict(toy.named_parameters())[n], before), n
            assert not dict(toy.named_parameters())[n].requires_grad


@pytest.mark.parametrize("accum", [1, 2])
def test_schedule_is_the_jax_schedule_step_by_step(accum):
    """The learning rate of each update is the JAX schedule at the 0-based
    update count, with ``steps_per_epoch // accum`` updates an epoch."""
    max_epoch, steps_per_epoch = 5, 6
    toy, _ = _toy_pair()
    opt = ptrain.TrainOptimizer(toy, lr=2e-3, lr_ft=5e-4, accum=accum, sched=(max_epoch, steps_per_epoch))
    jsched = {base: jtrain.epoch_cosine_schedule(base, max_epoch, steps_per_epoch // accum) for base in (2e-3, 5e-4)}
    for step in range(steps_per_epoch * (max_epoch + 1)):
        n = step // accum  # updates before this mini-batch's
        for group, base in (("scratch_decay", 2e-3), ("finetune_nodecay", 5e-4)):
            np.testing.assert_allclose(opt.lr(group), float(jsched[base](n)), rtol=1e-6)
        for p in toy.parameters():
            p.grad = torch.ones_like(p)
        opt.step()
    assert opt.updates == steps_per_epoch * (max_epoch + 1) // accum


def _tame_depth_head(v):
    """Keep the random depth head inside its [0, 1] clamp with spread
    (tests/test_torch_port_graph.py), so the depth loss has a gradient."""
    head = v["params"]["dpt_depth"]["head_conv3"]
    head["kernel"] = head["kernel"] * 1e-2
    head["bias"] = np.full_like(head["bias"], 0.5)


def _step_batch(B=4, seed=5):
    """``_batch`` at H=64 whose samples differ in brightness and mask rate.

    The JAX BatchNorm computes the batch variance as E[x^2] - E[x]^2 (flax's
    fast variance), which loses digits where samples are nearly alike; at
    the tiny sizes the deepest maps are 2x2 and the pooled features 1x1, so
    nearly alike samples would leave the two packages 1e-3 apart on the
    statistics for that reason alone.
    """
    b = dict(_batch(B=B, H=H_STEP, n_pts=64, seed=seed))
    rng = np.random.default_rng(seed + 1)
    keep = np.linspace(0.2, 0.9, B)[:, None, None, None]
    b["mask_input_map"] = jnp.asarray((rng.uniform(size=(B, H_STEP, H_STEP, 1)) < keep).astype(np.float32))
    b["rgb_input_map"] = b["rgb_input_map"] * jnp.asarray(np.linspace(0.3, 1.0, B)[:, None, None, None], jnp.float32)
    return b


def _flat(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def test_one_train_step_matches_jax(jax_graph, monkeypatch):
    """One step against ``make_train_step`` at a learning rate of 1e-2.

    * losses and attention statistics 1e-5, BatchNorm statistics 1e-4;
    * the gradient: each leaf of the port's against the one the JAX step
      applied, within 1e-4 of the leaf's norm plus 1e-7 of the whole
      gradient's norm (fp32 rounding: a few BatchNorm leaves of the
      coordinate encoder are near zero by structure, and there a float64
      run of the port and either fp32 run differ by up to 2e-2 of the leaf);
    * the update: the port's new parameters against the JAX optimizer applied
      to the port's gradients, 1e-4, which is 1% of AdamW's first update.
      (Against the JAX step's own parameters an element whose gradient lies
      within rounding of zero may take AdamW's step of +-lr either way.)

    The JAX step runs with flax's two-pass variance: its default,
    E[x^2] - E[x]^2, left some gradients of the DPT's GroupNorms 3% off a
    float64 run of the port, against 2e-5 for the port in fp32.
    """
    opt, jmodel, jbatch, v = jax_graph
    opt = copy.deepcopy(opt)
    opt.optim.lr = opt.optim.lr_ft = 1e-2
    popt = config.Config(opt)
    masks = [np.array([1 / 0.9, 0.0, 1 / 0.9, 0.0], np.float32), np.array([0.0, 1 / 0.9, 1 / 0.9, 1 / 0.9], np.float32)]

    def inject(next_fun, args, kwargs, context):
        if isinstance(context.module, JImplicit) and context.method_name == "_dp_masks":
            return [jnp.asarray(m) for m in masks]
        return next_fun(*args, **kwargs)

    stats_fn = fnn.normalization._compute_stats
    monkeypatch.setattr(fnn.normalization, "_compute_stats",
                        lambda *a, **kw: stats_fn(*a, **dict(kw, use_fast_variance=False)))
    # the JAX optimizer behind an identity stage that keeps the gradients it
    # passes on in its state, so one compile of the step gives both
    keep_grads = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
    adamw = jtrain.make_optimizer(v["params"], lr=1e-2, lr_ft=1e-2, weight_decay=opt.optim.weight_decay)
    tx = optax.chain(keep_grads, adamw)
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
                              opt_state=tx.init(v["params"]), tx=tx)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    step = jtrain.make_train_step(jmodel, opt, j_compute_loss, mesh, metrics_fn=j_attn_geo_stats)
    with fnn.intercept_methods(inject):
        new_state, jmetrics = step(state, jbatch, jax.random.PRNGKey(0))
    want_g = {k: np.asarray(g) for k, g in _flat(new_state.opt_state[0]).items()}
    want_stats = new_state.batch_stats
    del state, new_state  # a few GB of optimizer state: the test runs beside others

    port = ShapeGraph.from_opt(config.tiny_opt(H_STEP))
    weights.load(port, weights.from_flax(v["params"], v["batch_stats"], impl_mlp_linears=N_MLP_LINEARS))
    port.train()
    optimizer = ptrain.make_optimizer(port, popt.optim)
    grads = ptrain.capture_grads(port, optimizer)
    batch = {k: torch.tensor(np.asarray(x)) for k, x in jbatch.items()}
    metrics, stats = ptrain.train_step(port, optimizer, batch, popt, dp_masks=[torch.tensor(m) for m in masks],
                                       with_stats=True)
    del optimizer
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        close(metrics[k], jmetrics[k], 1e-5, k)
    assert stats and all(k.endswith(("running_mean", "running_var")) for k in stats)

    sd = {k: x.detach().numpy() for k, x in port.state_dict().items()}
    gsd = dict(sd, **{k: (grads[k] if k in grads else torch.zeros_like(p)).numpy() for k, p in port.named_parameters()})
    pgrads, _, report = convert_torch_state_dict(gsd, graph="shape", impl_mlp_linears=N_MLP_LINEARS)
    assert report["missing"] == []
    got_g = _flat(pgrads)
    floor = 1e-7 * np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in want_g.values()))
    bad = {jax.tree_util.keystr(k): float(np.abs(got_g[k] - g).max() / np.linalg.norm(g)) for k, g in want_g.items()
           if np.abs(got_g[k] - g).max() > 1e-4 * np.linalg.norm(g) + floor}
    assert not bad, f"gradient leaves off by more than 1e-4 of their norm + {floor:.2e}: {bad}"
    assert sum(np.linalg.norm(g) > 0 for g in want_g.values()) > 400

    params, bstats, report = convert_torch_state_dict(sd, graph="shape", impl_mlp_linears=N_MLP_LINEARS)
    assert report["missing"] == []
    del got_g, want_g, gsd
    stepped = jax.jit(lambda g, p: optax.apply_updates(p, adamw.update(g, adamw.init(p), p)[0]))(pgrads, v["params"])
    moved = 0
    for coll, got, want in (("params", params, stepped), ("batch_stats", bstats, want_stats)):
        got_flat, before = _flat(got), _flat(v[coll])
        for path, leaf in _flat(want).items():
            close(got_flat[path], leaf, 1e-4, f"{coll} {jax.tree_util.keystr(path)}")
            moved += not np.array_equal(got_flat[path], before[path])
    assert moved > 500  # the port's step moved its parameters and statistics
