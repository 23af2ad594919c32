"""One depth pretraining step of the port against ``make_train_step(model,
opt, graph_depth.compute_loss, mesh)`` (its own file: the JAX step's compile
is the slow part, and ``--dist loadfile`` spreads files over workers).

The depth graph at H=64 (full-width DPT and intrinsics head) under the
``depth_gen`` recipe at lr 1e-2, on four distinct images: losses 1e-5; each
gradient leaf against the one the JAX step applied, within 1e-4 of the
leaf's norm plus 1e-7 of the whole gradient's, plus 4x what the port's own
gradient of that leaf moves between 1 and all CPU threads; the updated
parameters against the JAX optimizer applied to the port's gradients and
the BatchNorm statistics, 1e-4. The JAX side runs with flax's two-pass
variance (see ``test_torch_port_train.py``).

The thread term is the rule of ``chip_smoke.step_disagreements``: the
GroupNorm and conv gradients of the DPT's ResNet stem are sums with much
cancellation, and in fp32 the port's own values of some of them move by up
to 8e-3 of the leaf's norm between 1 and 8 threads, while the two packages
differ there by at most 1e-3. Most leaves meet the bound without it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from flax import linen as fnn

from __graft_entry__ import _batch
from zeroshape_tpu.models import graph_depth as jgd
from zeroshape_tpu.parallel import train as jtrain
from zeroshape_tpu.runtime.checkpoint import convert_torch_state_dict
from zeroshape_tpu_torch import config, weights
from zeroshape_tpu_torch.losses import summarize_loss
from zeroshape_tpu_torch.models import graph_depth
from zeroshape_tpu_torch.models.graph_depth import DepthGraph
from zeroshape_tpu_torch.parallel import train as ptrain

from test_torch_harness import close, random_variables
from test_torch_harness import give_memory_back  # noqa: F401 (autouse: frees the module's memory at its end)

H = 64
KEYS = ("rgb_input_map", "mask_input_map", "depth_input_map", "intr")


def _flat(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def _step_batch(B=4, seed=5):
    """Four images that differ in brightness and mask rate (flax's batch
    variance loses digits where samples are nearly alike)."""
    b = {k: np.asarray(v) for k, v in _batch(B=B, H=H, n_pts=8, seed=seed).items() if k in KEYS}
    rng = np.random.default_rng(seed + 1)
    keep = np.linspace(0.2, 0.9, B)[:, None, None, None]
    b["mask_input_map"] = (rng.uniform(size=(B, H, H, 1)) < keep).astype(np.float32)
    b["rgb_input_map"] = (b["rgb_input_map"] * np.linspace(0.3, 1.0, B)[:, None, None, None]).astype(np.float32)
    return b


def _port_grads(opt, sd, batch, threads):
    """The port's gradient of one depth step's loss on ``threads`` CPU threads,
    in the JAX tree layout."""
    n = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        port = DepthGraph.from_opt(opt)
        weights.load(port, sd)
        port.train()
        total = summarize_loss(graph_depth.compute_loss(opt, batch, port(batch, train=True), training=True),
                               dict(opt.loss_weight))
        total.backward()
    finally:
        torch.set_num_threads(n)
    gsd = {k: x.detach().numpy() for k, x in port.state_dict().items()}
    gsd.update({k: p.grad.numpy() for k, p in port.named_parameters() if p.grad is not None})
    return convert_torch_state_dict(gsd, graph="depth")[0]


def test_one_depth_train_step_matches_jax(monkeypatch):
    opt = config.override_options(config.depth_gen_opt(H), {"optim": {"lr": 1e-2}})
    assert opt.optim.lr_ft is None  # the finetune groups (all of this graph) take lr, as optax does
    jmodel = jgd.DepthGraph.from_opt(opt)
    b = _step_batch()
    jbatch = {k: jnp.asarray(x) for k, x in b.items()}
    v = random_variables(jmodel, jbatch, train=False, seed=6)
    head = v["params"]["dpt_depth"]["head_conv3"]
    head["kernel"] = head["kernel"] * 1e-2
    head["bias"] = np.full_like(head["bias"], 0.5)

    stats_fn = fnn.normalization._compute_stats
    monkeypatch.setattr(fnn.normalization, "_compute_stats",
                        lambda *a, **kw: stats_fn(*a, **dict(kw, use_fast_variance=False)))
    # the JAX optimizer behind an identity stage that keeps the gradients it
    # passes on in its state, so one compile of the step gives both
    keep_grads = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
    adamw = jtrain.make_optimizer(v["params"], lr=1e-2, weight_decay=opt.optim.weight_decay)
    tx = optax.chain(keep_grads, adamw)
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
                              opt_state=tx.init(v["params"]), tx=tx)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    step = jtrain.make_train_step(jmodel, opt, jgd.compute_loss, mesh)
    new_state, jmetrics = step(state, jbatch, jax.random.PRNGKey(0))
    want_g = {k: np.asarray(g) for k, g in _flat(new_state.opt_state[0]).items()}
    want_stats = new_state.batch_stats
    del state, new_state

    sd0 = weights.from_flax(v["params"], v["batch_stats"], graph="depth")
    batch = {k: torch.tensor(x) for k, x in b.items()}
    one_thread = _flat(_port_grads(opt, sd0, batch, threads=1))
    port = DepthGraph.from_opt(opt)
    weights.load(port, sd0)
    port.train()
    optimizer = ptrain.make_optimizer(port, opt.optim)
    assert {g["lr"] for g in optimizer.adamw.param_groups} == {1e-2}
    grads = ptrain.capture_grads(port, optimizer)
    metrics, _ = ptrain.train_step(port, optimizer, batch, opt, loss_fn=graph_depth.compute_loss, metrics_fn=None)
    del optimizer
    assert set(metrics) == set(jmetrics) == {"loss_all", "loss_depth", "loss_intr"}
    for k in metrics:
        close(metrics[k], jmetrics[k], 1e-5, k)

    sd = {k: x.detach().numpy() for k, x in port.state_dict().items()}
    gsd = dict(sd, **{k: (grads[k] if k in grads else torch.zeros_like(p)).numpy() for k, p in port.named_parameters()})
    pgrads, _, report = convert_torch_state_dict(gsd, graph="depth")
    assert report["missing"] == []
    got_g = _flat(pgrads)
    floor = 1e-7 * np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in want_g.values()))
    strict = {k: np.abs(got_g[k] - g).max() <= 1e-4 * np.linalg.norm(g) + floor for k, g in want_g.items()}
    bad = {jax.tree_util.keystr(k): float(np.abs(got_g[k] - g).max() / np.linalg.norm(g)) for k, g in want_g.items()
           if np.abs(got_g[k] - g).max() > 1e-4 * np.linalg.norm(g) + floor + 4 * np.abs(got_g[k] - one_thread[k]).max()}
    assert not bad, f"gradient leaves off by more than 1e-4 of their norm + {floor:.2e} + 4x the thread spread: {bad}"
    assert sum(strict.values()) >= 0.9 * len(strict), f"{len(strict) - sum(strict.values())} leaves need the spread"
    # every leaf has a gradient but the ViT's last LayerNorm, whose output the DPT does not read
    unread = {k for k in want_g if k[:-1] == tuple(jax.tree_util.DictKey(n) for n in ("dpt_depth", "dpt", "pretrained", "norm"))}
    assert len(unread) == 2 and all(np.linalg.norm(want_g[k]) == np.linalg.norm(got_g[k]) == 0 for k in unread)
    assert all(np.linalg.norm(g) > 0 for k, g in want_g.items() if k not in unread)

    params, bstats, report = convert_torch_state_dict(sd, graph="depth")
    assert report["missing"] == []
    stepped = jax.jit(lambda g, p: optax.apply_updates(p, adamw.update(g, adamw.init(p), p)[0]))(pgrads, v["params"])
    moved = 0
    for coll, got, want in (("params", params, stepped), ("batch_stats", bstats, want_stats)):
        got_flat, before = _flat(got), _flat(v[coll])
        for path, leaf in _flat(want).items():
            close(got_flat[path], leaf, 1e-4, f"{coll} {jax.tree_util.keystr(path)}")
            moved += not np.array_equal(got_flat[path], before[path])
    assert moved > 300  # the step moved the parameters and the statistics
