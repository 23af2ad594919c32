"""PyTorch port vs the JAX package: the depth pretraining graph, its loss and
the depth metrics.

* ``DepthGraph`` at H=64 (full-width DPT and intrinsics head), JAX
  variables drawn with numpy and converted by ``weights.from_flax(graph=
  "depth")``: every output within 1e-4 in fp32, in eval mode and with
  BatchNorm on batch statistics;
* ``graph_depth.compute_loss`` on those outputs: 1e-4;
* ``compute_depth_metrics``: 1e-5 on a batch with a row whose ``det`` is 0
  (a constant prediction), an all-background row and a depth cap.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _batch
from zeroshape_tpu.metrics import depth_metrics as jdm
from zeroshape_tpu.models import graph_depth as jgd
from zeroshape_tpu_torch import config, weights
from zeroshape_tpu_torch.metrics import depth_metrics as dm
from zeroshape_tpu_torch.models import graph_depth
from zeroshape_tpu_torch.models.graph_depth import DepthGraph

from test_torch_harness import close, random_variables, t
from test_torch_harness import give_memory_back  # noqa: F401 (autouse: frees the module's memory at its end)

H = 64
OUT_KEYS = ("depth_pred", "intr_pred", "validity_mask", "seen_points_pred", "seen_points_gt")


def depth_batch(B=2, seed=5):
    """``_batch``'s depth-graph keys at H=64, samples of different brightness
    and mask rate (flax's fast batch variance needs samples that differ)."""
    b = {k: np.asarray(v) for k, v in _batch(B=B, H=H, n_pts=8, seed=seed).items()
         if k in ("rgb_input_map", "mask_input_map", "depth_input_map", "intr")}
    rng = np.random.default_rng(seed + 1)
    keep = np.linspace(0.3, 0.9, B)[:, None, None, None]
    b["mask_input_map"] = (rng.uniform(size=(B, H, H, 1)) < keep).astype(np.float32)
    b["rgb_input_map"] = (b["rgb_input_map"] * np.linspace(0.4, 1.0, B)[:, None, None, None]).astype(np.float32)
    return b


@pytest.fixture(scope="module")
def graphs():
    opt = config.depth_gen_opt(H)
    jmodel = jgd.DepthGraph.from_opt(opt)
    b = depth_batch()
    v = random_variables(jmodel, {k: jnp.asarray(x) for k, x in b.items()}, train=False, seed=4)
    # keep the random depth head inside the [0, 1] clamp with spread
    head = v["params"]["dpt_depth"]["head_conv3"]
    head["kernel"] = head["kernel"] * 1e-2
    head["bias"] = np.full_like(head["bias"], 0.5)
    port = DepthGraph.from_opt(opt)
    weights.load(port, weights.from_flax(v["params"], v["batch_stats"], graph="depth"))
    want = jmodel.apply(v, {k: jnp.asarray(x) for k, x in b.items()}, train=False)  # the eval outputs, once
    return opt, jmodel, v, port.eval(), b, want


def test_from_flax_fills_the_depth_graph(graphs):
    """Every key of the port's depth graph comes from the JAX tree, but the
    counters, and the refinenet4 unit that never runs."""
    _, _, v, port, _, _ = graphs
    sd = weights.from_flax(v["params"], v["batch_stats"], graph="depth")
    rest = set(port.state_dict()) - set(sd)
    assert rest and all(k.endswith("num_batches_tracked") or "refinenet4.resConfUnit1." in k for k in rest)
    assert {k.split(".")[0] for k in sd} == {"dpt_depth", "intr_head", "intr_proj"}


@pytest.mark.parametrize("train", [False, True])
def test_depth_graph_matches_jax(graphs, train):
    _, jmodel, v, port, b, want = graphs
    if train:
        want, _ = jmodel.apply(v, {k: jnp.asarray(x) for k, x in b.items()}, train=True, mutable=["batch_stats"])
    port = copy.deepcopy(port).train(train)  # a train-mode forward moves the running statistics
    with torch.no_grad():
        got = port({k: t(x) for k, x in b.items()}, train=train)
    assert set(got) == set(want) == set(OUT_KEYS)
    for k in OUT_KEYS:
        close(got[k], want[k], 1e-4, k)


def test_depth_loss_matches_jax(graphs):
    opt, _, _, port, b, out = graphs
    want = jgd.compute_loss(opt, {k: jnp.asarray(x) for k, x in b.items()}, out)
    pb = {k: t(x) for k, x in b.items()}
    with torch.no_grad():
        got = graph_depth.compute_loss(opt, pb, port(pb, train=False))
    assert set(got) == set(want) == {"depth", "intr"}  # the intrinsics loss outside training too
    for k in got:
        close(got[k], want[k], 1e-4, k)


def test_depth_graph_without_intrinsics(graphs):
    opt = config.override_options(config.depth_gen_opt(H), {"loss_weight": {"intr": None}})
    port = DepthGraph.from_opt(opt).eval()
    assert not hasattr(port, "intr_head") and not hasattr(port, "intr_proj")
    with torch.no_grad():
        out = port({k: t(x) for k, x in graphs[4].items()})
    assert set(out) == {"depth_pred"}


def metric_inputs(B=4, seed=7):
    """Random depth maps ``[B, 1, H, W]``: row 1 a constant prediction (its
    disparity exactly 1, so ``det`` is exactly 0), row 2 all background."""
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0.3, 2.0, (B, 1, H, H)).astype(np.float32)
    target = rng.uniform(0.4, 1.5, (B, 1, H, H)).astype(np.float32)
    mask = (rng.uniform(size=(B, 1, H, H)) > 0.4).astype(np.float32)
    pred[1] = np.float32(1.0 - 1e-6)  # + 1e-6 rounds to 1.0 in fp32
    assert np.float32(1.0) / (pred[1, 0, 0, 0] + np.float32(1e-6)) == 1.0
    mask[2] = 0.0
    return pred, target, mask


@pytest.mark.parametrize("depth_cap", [None, 1.2])
def test_depth_metrics_match_jax(depth_cap):
    pred, target, mask = metric_inputs()
    want, want_depth = jdm.compute_depth_metrics(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask),
                                                 depth_cap=depth_cap)
    got, got_depth = dm.compute_depth_metrics(t(pred), t(target), t(mask), depth_cap=depth_cap)
    assert list(got) == list(want) == dm.metric_keys() == jdm.metric_keys()
    for k in got:
        close(got[k], want[k], 1e-5, k)
    close(got_depth, want_depth, 1e-5, "aligned depth")
    assert all(float(got[k][2]) == 0.0 for k in got)  # no valid pixel: every metric 0


def test_scale_and_shift_rejects_rows_without_a_positive_det():
    pred, target, mask = metric_inputs()
    m = t(mask[:, 0])
    disp = m / (t(pred[:, 0]) + 1e-6)
    tdisp = m / torch.where(m > 0, t(target[:, 0]), 1.0)
    got = dm._scale_and_shift(disp, tdisp, m)
    want = jdm._scale_and_shift(jnp.asarray(disp.numpy()), jnp.asarray(tdisp.numpy()), jnp.asarray(m.numpy()))
    for g, w in zip(got, want):
        close(g, w, 1e-5)
        assert float(g[1]) == float(g[2]) == 0.0  # the constant row and the empty row are not solved
    assert float(got[0][0]) != 0.0 and float(got[0][3]) != 0.0
