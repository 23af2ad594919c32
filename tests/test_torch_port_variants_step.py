"""One training step of the non-default encoders against ``make_train_step``.

``config.encoders_opt`` at tiny width (both transformer encoders with 2
blocks, the coordinate map downsampled by 2; latent and decoder C 64) at
H=64, batch 4, every loss weighted, lr 1e-2, fp32: the port's
``parallel.train.train_step`` against the JAX step on the same numpy-drawn
variables and batch. Losses and attention statistics 1e-5, BatchNorm
statistics 1e-4, each parameter's gradient within 1e-4 of its leaf's norm
plus 1e-7 of the whole gradient's (the bound of
tests/test_torch_port_train.py), matched leaf by leaf through
``weights.map_shape_graph(opt=)``, plus 4x what the port's own gradient of
the leaf moves between 1 and all CPU threads, as
tests/test_torch_port_depth_step.py allows: on these weights the DPT's
ResNet-stem GroupNorm and conv gradients are sums with much cancellation
(the port's own values of a few move by ~1e-3 of their norm between thread
counts). At least 90% of the leaves meet the bound without that term.

Both packages take the same stochastic depth: the decoder's masks through
an interceptor on ``Implicit._dp_masks``, each transformer block's two masks
through one on ``DropPath.__call__`` (by the module's path), and the port
gets them all as ``dp_masks`` by module. Every mask keeps some samples and
drops others. Its own file: the JAX step's compile takes most of its time.
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from flax import linen as fnn

from __graft_entry__ import _batch
from zeroshape_tpu.models import layers as jl
from zeroshape_tpu.models.graph_shape import ShapeGraph as JShapeGraph
from zeroshape_tpu.models.graph_shape import attn_geo_stats as j_attn_geo_stats
from zeroshape_tpu.models.graph_shape import compute_loss as j_compute_loss
from zeroshape_tpu.models.implicit import Implicit as JImplicit
from zeroshape_tpu.parallel import train as jtrain
from zeroshape_tpu_torch import config, weights
from zeroshape_tpu_torch.models.graph_shape import ShapeGraph
from zeroshape_tpu_torch.parallel import train as ptrain

from test_torch_harness import close, random_variables
from test_torch_harness import give_memory_back  # noqa: F401 (autouse: frees the module's memory at its end)

H, B, BLOCKS = 64, 4, 2


def tiny_encoders_opt():
    opt = config.encoders_opt(H)
    tiny = config.tiny_opt(H)
    opt.arch.latent_dim, opt.arch.impl = tiny.arch.latent_dim, tiny.arch.impl
    opt.arch.depth.n_blocks = opt.arch.rgb.n_blocks = BLOCKS
    opt.arch.dtype = "float32"
    opt.loss_weight = {"shape": 1, "depth": 1, "intr": 10}
    opt.optim.lr = opt.optim.lr_ft = 1e-2
    return opt


def step_batch(seed=5):
    """``_batch`` whose samples differ in brightness and mask rate (the
    BatchNorm statistics of the intrinsics head stay well-conditioned)."""
    b = {k: np.array(x) for k, x in _batch(B=B, H=H, n_pts=64, seed=seed).items()}
    rng = np.random.default_rng(seed + 1)
    b["mask_input_map"] = (rng.uniform(size=(B, H, H, 1)) < np.linspace(0.2, 0.9, B)[:, None, None, None])
    b["mask_input_map"] = b["mask_input_map"].astype(np.float32)
    b["rgb_input_map"] = (b["rgb_input_map"] * np.linspace(0.3, 1.0, B)[:, None, None, None]).astype(np.float32)
    return b


def encoder_masks(seed=7):
    """``{DropPath path: [B] mask}`` for every transformer block of both
    encoders, each keeping some samples (scaled by 1 / 0.9) and dropping others."""
    rng = np.random.default_rng(seed)
    out = {}
    for enc in ("rgb_encoder", "coord_encoder"):
        for i in range(BLOCKS):
            for j in (1, 2):
                keep = rng.uniform(size=B) < 0.6
                keep[(i + j) % B], keep[(i + j + 1) % B] = True, False
                out[(enc, f"block{i}", f"drop_path{j}")] = (keep / 0.9).astype(np.float32)
    return out


def port_step(opt, sd, batch, dp_masks, threads=None):
    """The port's step from the state dict ``sd`` on ``threads`` CPU threads
    (all by default): ``(metrics, BatchNorm statistics, gradients)``."""
    n = torch.get_num_threads()
    torch.set_num_threads(threads or n)
    try:
        port = weights.load(ShapeGraph.from_opt(opt), sd).train()
        optimizer = ptrain.make_optimizer(port, opt.optim)
        grads = ptrain.capture_grads(port, optimizer)
        metrics, stats = ptrain.train_step(port, optimizer, batch, opt, dp_masks=dp_masks, with_stats=True)
    finally:
        torch.set_num_threads(n)
    return metrics, {k: x.clone() for k, x in stats.items()}, grads


def test_one_train_step_of_the_encoders_matches_jax(monkeypatch):
    opt = tiny_encoders_opt()
    jmodel = JShapeGraph.from_opt(opt)
    jbatch = {k: jnp.asarray(x) for k, x in step_batch().items()}
    v = random_variables(jmodel, jbatch, train=False, seed=2)
    head = v["params"]["dpt_depth"]["head_conv3"]  # inside the depth head's clamp, with spread
    head["kernel"] = head["kernel"] * 1e-2
    head["bias"] = np.full_like(head["bias"], 0.5)
    dec_masks = [np.array([1 / 0.9, 0.0, 1 / 0.9, 0.0], np.float32), np.array([0.0, 1 / 0.9, 1 / 0.9, 1 / 0.9], np.float32)]
    enc_masks = encoder_masks()
    used = set()

    def inject(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, JImplicit) and context.method_name == "_dp_masks":
            return [jnp.asarray(m) for m in dec_masks]
        if (isinstance(mod, jl.DropPath) and context.method_name == "__call__" and mod.rate > 0
                and kwargs.get("mask") is None):
            used.add(tuple(mod.path))
            kwargs = dict(kwargs, mask=jnp.asarray(enc_masks[tuple(mod.path)]))
        return next_fun(*args, **kwargs)

    stats_fn = fnn.normalization._compute_stats  # flax's two-pass variance (tests/test_torch_port_train.py)
    monkeypatch.setattr(fnn.normalization, "_compute_stats",
                        lambda *a, **kw: stats_fn(*a, **dict(kw, use_fast_variance=False)))
    # an identity stage that keeps the gradients it passes on: one compile gives them
    keep_grads = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
    tx = optax.chain(keep_grads, jtrain.make_optimizer(v["params"], lr=1e-2, lr_ft=1e-2,
                                                       weight_decay=opt.optim.weight_decay))
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
                              opt_state=tx.init(v["params"]), tx=tx)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    step = jtrain.make_train_step(jmodel, opt, j_compute_loss, mesh, metrics_fn=j_attn_geo_stats)
    with fnn.intercept_methods(inject):
        new_state, jmetrics = step(state, jbatch, jax.random.PRNGKey(0))
    assert used == set(enc_masks)  # every encoder block took its masks
    jgrads = jax.tree.map(np.asarray, new_state.opt_state[0])
    want_stats = jax.tree.map(np.asarray, new_state.batch_stats)
    del state, new_state

    entries = weights.map_shape_graph(opt=opt)
    sd = weights.from_flax(v["params"], v["batch_stats"], opt=opt)
    dp_masks = {"impl_network": [torch.tensor(m) for m in dec_masks]}
    for enc in ("rgb_encoder", "coord_encoder"):
        dp_masks[enc] = [tuple(torch.tensor(enc_masks[(enc, f"block{i}", f"drop_path{j}")]) for j in (1, 2))
                         for i in range(BLOCKS)]
    batch = {k: torch.tensor(np.asarray(x)) for k, x in jbatch.items()}
    metrics, stats, grads = port_step(opt, sd, batch, dp_masks)
    one_thread = port_step(opt, sd, batch, dp_masks, threads=1)[2]

    assert set(metrics) == set(jmetrics)
    for k in metrics:
        close(metrics[k], jmetrics[k], 1e-5, k)
    want_bn = weights.convert([e for e in entries if e[1] == "batch_stats"], {}, want_stats)
    assert want_bn
    for k, x in want_bn.items():
        close(stats[k], x, 1e-4, k)

    want_g = weights.convert([e for e in entries if e[1] == "params"], jgrads)
    total = float(np.sqrt(sum(float((g.double() ** 2).sum()) for g in want_g.values())))
    bad, strict = {}, 0
    for k, g in want_g.items():
        got, one = grads.get(k, torch.zeros_like(g)), one_thread.get(k, torch.zeros_like(g))
        d, bound = float((got - g).abs().max()), 1e-4 * float(g.norm()) + 1e-7 * total
        strict += d <= bound
        if d > bound + 4 * float((got - one).abs().max()):
            bad[k] = d / max(float(g.norm()), 1e-30)
    assert not bad, f"gradient leaves off by more than 1e-4 of their norm + {1e-7 * total:.2e} + 4x the thread spread: {bad}"
    assert strict >= 0.9 * len(want_g), f"{len(want_g) - strict} of {len(want_g)} leaves need the thread spread"
    live = {k for k, g in want_g.items() if float(g.norm()) > 0}
    for enc in ("coord_encoder.blocks.", "coord_encoder.coord_embed.", "rgb_encoder.blocks.", "rgb_encoder.patch_embed"):
        assert any(k.startswith(enc) for k in live), enc  # the loss reaches both encoders
