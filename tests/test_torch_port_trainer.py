"""The port's trainer: its analytic training split against the JAX loader,
``python -m zeroshape_tpu_torch.train`` at tiny size on the CPU on an
analytic tree on disk (checkpoints in the reference layout, read back by the
JAX importer; the JAX engine's scalar tags), resume, and the finite-loss
gate.

The encoders keep their full width at the tiny size, so a checkpoint holds
about 1.2 GB: the runs train with the DPT frozen (``fix_dpt``, no optimizer
state for it), write ``latest.ckpt`` every third step, and their
directories are removed when the tests are done.
"""

import copy
import inspect
import os
import re
import shutil

import numpy as np
import pytest
import torch

from zeroshape_tpu.config import Config as JConfig
from zeroshape_tpu.data.analytic import generate_dataset
from zeroshape_tpu.data.base import DataLoader
from zeroshape_tpu.data.synthetic import SyntheticDataset
from zeroshape_tpu.runtime.checkpoint import load_torch_checkpoint
from zeroshape_tpu_torch import config, weights
from zeroshape_tpu_torch.data import analytic
from zeroshape_tpu_torch.data.synthetic import SyntheticDataset as PortSynthetic
from zeroshape_tpu_torch.parallel import train as ptrain
from zeroshape_tpu_torch.runtime import engine_base, shape_engine
from zeroshape_tpu_torch.train import main as train_main
from zeroshape_tpu_torch.train import options as train_options

from test_torch_harness import few_threads, give_memory_back  # noqa: F401 (autouse: two threads; memory back at the end)

H = 32
N_SDF = 64
SEED = 3  # the run's seed (loader order, SDF subsets, stochastic depth, weights)
DATA = dict(n_objects=2, n_views=3, seed=0, n_pc_points=300, n_sdf_points=400)

# the tiny decoder of config.tiny_opt, the run's cadences and a small validation
TINY = [f"--image_size=[{H},{H}]", "--arch.latent_dim=64", "--arch.impl.n_channels=64", "--arch.impl.mlp_layers=4",
        "--arch.impl.skip_in=[2]", "--arch.depth.n_blocks=2", "--batch_size=2", "--max_epoch=2", f"--seed={SEED}",
        f"--training.n_sdf_points={N_SDF}", "--optim.fix_dpt", "--tb=null",
        "--freq.print=1", "--freq.scalar=1", "--freq.ckpt_latest=3", "--eval.vox_res=16",
        "--eval.num_points=200", "--device=cpu"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The runs' data: the analytic tree of ``DATA`` written by the port."""
    root = tmp_path_factory.mktemp("tree")
    analytic.generate_dataset(str(root), H=H, **DATA)
    return [f"--data.root={root}"]


@pytest.mark.parametrize("epoch", [0, 1])
def test_train_samples_match_the_jax_loader(tmp_path, epoch):
    """``train_samples`` against ``generate_dataset`` read back by
    ``SyntheticDataset`` (train and test splits) and the loader's order."""
    generate_dataset(str(tmp_path), H=H, **DATA)
    opt = JConfig({"H": H, "W": H, "seed": SEED, "batch_size": 2, "training": {"n_sdf_points": N_SDF},
                   "data": {"root": str(tmp_path), "num_workers": 1, "synthetic": {"subset": "analytic"}}})
    ours = analytic.train_samples(H=H, **DATA)
    theirs = SyntheticDataset(opt, split="train")
    theirs.set_epoch(epoch)
    assert len(ours) == len(theirs) == 4
    for i in range(len(theirs)):
        got, want = ours.sample(i, epoch, SEED, N_SDF), theirs[i]
        assert set(got) <= set(want)
        for k, v in got.items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    val = SyntheticDataset(opt, split="test")
    assert len(ours.val) == len(val) == 2
    for got, want in zip(ours.val, (val[i] for i in range(len(val)))):
        for k in ("idx", "category_label", "pose_gt", "rgb_input_map", "mask_input_map"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got["dpc"]["points"], want["dpc"]["points"])
    loader = DataLoader(theirs, batch_size=2, shuffle=True, drop_last=True, seed=SEED)
    loader.set_epoch(epoch)
    for got, want in zip(ours.batch_order(epoch, 2, SEED), loader._batch_indices(), strict=True):
        np.testing.assert_array_equal(got, want)


def test_cli_options_follow_the_shape_gen_yaml():
    """The CLI's options read ``options/shape_gen.yaml`` as the JAX loader does
    on every key the recipe sets; without ``--yaml`` they are the same recipe."""
    from zeroshape_tpu.config import load_options

    yaml = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "options", "shape_gen.yaml")
    ref = load_options(yaml)
    for with_yaml in (True, False):
        opt = train_options([f"--yaml={yaml}"] if with_yaml else [])
        for key in ("batch_size", "max_epoch"):
            assert opt[key] == ref[key], key
        for sec in ("loss_weight", "optim", "training", "freq"):
            for k, v in ref[sec].items():
                if sec != "freq" or k in opt.freq:
                    assert opt[sec][k] == v, (sec, k)
        for k in ("batch_size", "vox_res", "brute_force", "num_points", "range", "hier_decode", "f_thresholds"):
            assert opt.eval[k] == ref.eval[k], k
        assert opt.arch.depth.head_init_scale == ref.arch.depth.head_init_scale
        assert (opt.H, opt.W) == tuple(ref.image_size)


@pytest.fixture(scope="module", autouse=True)
def init_once():
    """Every run here starts from the same seeded weights: draw them once
    (``init_like_flax`` takes ~15 s for the full-width encoders) and load
    them into each run's graph."""
    cache = {}

    def init(graph, seed=0):
        if seed not in cache:
            cache[seed] = {k: v.clone() for k, v in weights.init_like_flax(graph, seed).state_dict().items()}
        graph.load_state_dict(cache[seed])
        return graph

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(shape_engine, "init_like_flax", init)
        yield


class _Scalars:
    """Stands in for TensorBoard's writer: records ``(tag, value, step)``."""

    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, step):
        self.rows.append((tag, float(value), step))

    def flush(self):
        pass


@pytest.fixture(scope="module")
def run(tmp_path_factory, tree):
    """Two epochs of two steps through the CLI, validation after each epoch,
    the scalars of every step recorded."""
    out = tmp_path_factory.mktemp("run")
    scalars = _Scalars()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(engine_base, "scalar_writer", lambda path, enabled: scalars)
            res = train_main(TINY + tree + [f"--output_path={out}", "--freq.eval=1"])
        yield out, res, scalars
    finally:
        shutil.rmtree(out)


def test_train_writes_reference_checkpoints_the_jax_importer_reads(run):
    out, res, _ = run
    assert res["it"] == 4 and len(res["losses"]) == 4 and np.isfinite(res["losses"]).all()
    assert [ep for ep, _ in res["val"]] == [0, 1, 2] and np.isfinite([cd for _, cd in res["val"]]).all()
    params, stats, report, meta = load_torch_checkpoint(str(out / "best.ckpt"), graph="shape", impl_mlp_linears=5)
    assert report["missing"] == [] and report["unconsumed"] == []
    assert meta["best_ep"] == res["best_ep"] and params["impl_network"] and stats["coord_encoder"]
    final = res["graph"].state_dict()
    for name, ep, it in (("latest.ckpt", 1, 4), ("checkpoint/ep1.ckpt", 1, 4)):
        ckpt = torch.load(out / name, weights_only=True, mmap=True)
        assert set(ckpt) == {"graph", "epoch", "iter", "best_val", "best_ep", "optim"}
        assert (ckpt["epoch"], ckpt["iter"], ckpt["best_val"]) == (ep, it, res["best_val"]), name
        for k, v in ckpt["graph"].items():
            assert torch.equal(v, final[k]), (name, k)
    assert not [f for f in os.listdir(out) if f.endswith(".tmp")]


class _Stop(Exception):
    pass


def test_resume_mid_epoch_is_bit_equal(run, tree, tmp_path, monkeypatch):
    """Stopped before its second step (mid-epoch 1) and resumed from
    ``latest.ckpt``, a run ends with the parameters of the uninterrupted one
    (validation, which changes no parameter, only before the first step)."""
    _, full, _ = run
    step = ptrain.train_step
    calls = []

    def stop_at_second(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise _Stop
        return step(*args, **kwargs)

    argv = TINY + tree + [f"--output_path={tmp_path}", "--freq.eval=100"]
    try:
        monkeypatch.setattr(ptrain, "train_step", stop_at_second)
        with pytest.raises(_Stop):
            train_main(argv)
        assert torch.load(tmp_path / "latest.ckpt", weights_only=True, mmap=True)["iter"] == 1
        monkeypatch.setattr(ptrain, "train_step", step)
        resumed = train_main(argv + ["--resume"])
        assert resumed["it"] == 4 and resumed["losses"] == full["losses"][1:]
        want = full["graph"].state_dict()
        for k, v in resumed["graph"].state_dict().items():
            assert torch.equal(v, want[k]), k
    finally:
        shutil.rmtree(tmp_path)


def test_nan_loss_trips_the_finite_gate(run):
    _, res, _ = run
    graph = copy.deepcopy(res["graph"])
    opt = train_options(TINY)
    data = analytic.train_samples(H=H, **DATA)
    batch = data.batch([0, 1], 0, SEED, N_SDF)
    batch["rgb_input_map"][1, 5, 5] = np.nan
    gate = engine_base.LossGate()
    metrics, _ = ptrain.train_step(graph, ptrain.make_optimizer(graph, opt.optim), shape_engine.to_device(
        batch, torch.device("cpu")), opt, shape_engine.step_generator(SEED, 0, "cpu"))
    gate.note(metrics["loss_all"])
    with pytest.raises(FloatingPointError, match="not finite within 1 iters of iter 7"):
        gate.flush(7)


def test_scalars_are_the_jax_engines(run, tree):
    """The run logs the JAX engine's scalar tags and no other: every step's
    ``train/`` metrics (``loss_*`` and the attention statistics at the scalar
    cadence) with ``train/dist_acc`` / ``train/dist_cov``, and
    ``eval/dist_acc`` / ``eval/dist_cov`` at each validation
    (``zeroshape_tpu/runtime/shape_engine.py:709-710, 826-849``). The last
    step's train-split metrics equal the port's own ``evaluate`` of the first
    ``eval.batch_size`` samples of that step's batch, with the graph the run
    ended with."""
    from zeroshape_tpu.models import graph_shape as jax_graph_shape
    from zeroshape_tpu.runtime import shape_engine as jax_shape_engine

    out, res, scalars = run
    logged = set(re.findall(r'log_scalar\(\s*"([^"]+)"', inspect.getsource(jax_shape_engine)))
    attn = re.findall(r'"(attn_geo_\w+)":', inspect.getsource(jax_graph_shape.attn_geo_stats))
    opt = train_options(TINY + tree)
    losses = ["loss_all"] + [f"loss_{k}" for k in ("depth", "intr", "shape") if opt.loss_weight.get(k) is not None]
    want_train = {f"train/{k}" for k in losses + attn} | {t for t in logged if t.startswith("train/")}
    want_eval = {t for t in logged if t.startswith("eval/")}
    assert want_eval == {"eval/dist_acc", "eval/dist_cov"} and {"train/dist_acc", "train/dist_cov"} <= want_train
    by_step = {}
    for tag, value, step in scalars.rows:
        assert np.isfinite(value), tag
        by_step.setdefault((tag.split("/")[0], step), set()).add(tag)
    assert {k: v for k, v in by_step.items() if k[0] == "train"} == {("train", it): want_train for it in range(4)}
    assert {k: v for k, v in by_step.items() if k[0] == "eval"} == {("eval", ep): want_eval for ep in range(3)}
    # the last step's batch, its first eval.batch_size samples, scored again
    data = PortSynthetic(config.Config(opt), split="train")
    loader = data.setup_loader(opt, shuffle=True, drop_last=True)
    loader.set_epoch(1)
    rows = [data[int(i)] for i in loader._batch_indices()[1][: opt.eval.batch_size]]
    got = shape_engine.evaluate(shape_engine.recon_model(copy.deepcopy(res["graph"]), torch.device("cpu")), rows,
                                opt, str(out), None, training=True, device="cpu", seed=shape_engine.TRAIN_METRIC_SEED)
    last = {tag: value for tag, value, step in scalars.rows if step == 3 and tag in ("train/dist_acc", "train/dist_cov")}
    np.testing.assert_allclose([last["train/dist_acc"], last["train/dist_cov"]],
                               [got["acc"].mean(), got["comp"].mean()], rtol=1e-6, atol=1e-7)
