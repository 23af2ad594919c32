"""The port's visual dumps end to end: the demo CLI in its three runs, the
train CLI's and a final evaluation's folders, and the demo's checkpoint
rule (C3).

Every run writes exactly the files the JAX package writes; the sets below
name the JAX line of each. The demo's depth task is held to the JAX
``DepthGraph`` and ``camera.unproj_depth`` on the same weights and inputs: the
seen-surface OBJ vertices (printed at 4 decimals) within 1e-4. A mesh that
marching cubes finds empty is skipped with "Mesh is empty!" by both packages,
with its turntable.
"""

import copy
import os
import pickle
import re
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshape_tpu import camera as jcamera
from zeroshape_tpu.models import graph_depth as jgd
from zeroshape_tpu_torch import config, demo, gif, recon, weights
from zeroshape_tpu_torch import evaluate as evaluate_cli
from zeroshape_tpu_torch import train as train_cli
from zeroshape_tpu_torch.data import native
from zeroshape_tpu_torch.data.analytic import generate_dataset
from zeroshape_tpu_torch.data.synthetic import SyntheticDataset
from zeroshape_tpu_torch.models.graph_depth import DepthGraph

from test_torch_harness import random_variables
from test_torch_harness import give_memory_back  # noqa: F401 (autouse: memory back at the end)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = 64
DEMO = ["--device=cpu", f"--image_size=[{H},{H}]", "--eval.vox_res=16", "--eval.num_points=100"]
# the files of an image <n> in <datadir>/preds, with the JAX demo's line that writes each
SHAPE_FILES = {
    "image_input.png": "demo.py:201",  # vis.dump_images
    "mask_input.png": "demo.py:204",
    "attn.gif": "demo.py:212",  # vis.dump_attentions, eval.dump_attn only
    "mesh.ply": "demo.py:215",  # vis.dump_meshes (skipped for an empty mesh)
    "mesh_viz.gif": "demo.py:218",  # vis.dump_meshes_viz (the same)
}
DEPTH_FILES = {
    "image_input.png": "demo.py:234",
    "mask_input.png": "demo.py:237",
    "depth_est.png": "demo.py:240",  # vis.dump_depths, rescale=True
    "seen_surface_fixed.obj": "demo.py:244", "seen_surface_fixed.mtl": "demo.py:244",  # vis.dump_seen_surface
    "seen_surface_pred.obj": "demo.py:248", "seen_surface_pred.mtl": "demo.py:248",
}
# the evaluation and training dumps of a sample <i>, with the JAX engine's lines
EVAL_FILES = {
    "image_input.png": "shape_engine.py:783", "mask_input.png": "shape_engine.py:787",
    "mesh.ply": "shape_engine.py:797", "mesh_viz.gif": "shape_engine.py:810",  # skipped for an empty mesh
    "depth_est.png": "shape_engine.py:815", "pointclouds_comp.ply": "shape_engine.py:821",
}
VIZ_FILES = {  # _dump_viz_samples: dump_results(train=True) without turntables, the attention GIF, the seen surface
    "image_input.png": "shape_engine.py:783", "mask_input.png": "shape_engine.py:787",
    "mesh.ply": "shape_engine.py:797", "depth_est.png": "shape_engine.py:815",
    "pointclouds_comp.ply": "shape_engine.py:821", "attn.gif": "shape_engine.py:920",
    "seen_surface.ply": "shape_engine.py:922",
}
EMPTY_MESH = ("mesh.ply", "mesh_viz.gif")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (``test_torch_harness.few_threads`` gives two).
    This module runs many small ops, each of which waits at a barrier for
    all its threads; when the xdist workers oversubscribe the cores, two
    threads made it ~25% slower than one (one is ~15% slower alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def built():
    """``recon.build`` made once for the module's shape demo runs: each run
    gets a copy of the seeded model the real build returns for its options
    (the same weights; the build is most of a demo run's time here)."""
    cache, real = {}, recon.build

    def build(opt, device=None, seed=0):
        key = (repr(opt.arch), opt.H, opt.W, str(device), seed)
        if key not in cache:
            cache[key] = real(opt, device=device, seed=seed)
        return copy.deepcopy(cache[key])

    return build


@pytest.fixture
def examples(tmp_path):
    data = tmp_path / "examples"
    shutil.copytree(os.path.join(REPO, "examples"), data, ignore=shutil.ignore_patterns("preds"))
    return data


def _names(data):
    return [n[:-4] for n in sorted(os.listdir(data / "images"))]


def _expected(names, files, empty=()):
    """``{name}_{file}`` for every name, less the mesh files of empty meshes."""
    return sorted(f"{n}_{f}" for n in names for f in files if not (n in empty and f in EMPTY_MESH))


def _empty_meshes(log):
    """The names whose mesh was empty, from the 'Mesh is empty!' lines, each
    printed before that image's 'done' line."""
    empty, pending = [], 0
    for line in log.splitlines():
        if line == "Mesh is empty!":
            pending += 1
        m = re.match(r"\[(\d+)/\d+\] (\S+) done", line)
        if m and pending:
            empty.append(m.group(2))
            pending = 0
    return empty


def _check_file(path):
    if path.endswith(".png"):
        img = native.decode_png(path)
        assert img.shape[:2] == (H, H) and img.dtype == np.uint8, (path, img.shape)
    elif path.endswith(".gif"):
        info = gif.info(path)
        assert info["size"] == ((H, H) if path.endswith("attn.gif") else (320, 320)) and info["loop"] == 0
        return info["frames"]
    elif path.endswith(".ply"):
        with open(path, "rb") as f:
            assert f.read(36) == b"ply\nformat binary_little_endian 1.0\n"
    elif path.endswith(".obj"):
        with open(path) as f:
            assert f.readline().startswith("mtllib ")


@pytest.mark.parametrize("dump_attn", [True, False])
def test_demo_shape_task_writes_the_jax_files(examples, capsys, monkeypatch, built, dump_attn):
    monkeypatch.setattr(recon, "build", built)
    demo.main([f"--datadir={examples}"] + DEMO + ([] if dump_attn else ["--eval.dump_attn!"]))
    log = capsys.readouterr().out
    names = _names(examples)
    empty = _empty_meshes(log)
    files = [f for f in SHAPE_FILES if dump_attn or f != "attn.gif"]
    got = sorted(os.listdir(examples / "preds"))
    assert got == _expected(names, files, empty), got
    assert len(empty) < len(names)  # a mesh and its turntable are written
    frames = {f: _check_file(str(examples / "preds" / f)) for f in got}
    assert all(n == 15 for f, n in frames.items() if f.endswith("mesh_viz.gif"))
    assert all(n == 2 * 3 for f, n in frames.items() if f.endswith("attn.gif"))  # rows 0, 8 x columns 0, 8, 16
    assert re.search(r"==> reconstruction: \d+\.\d{3} s/image steady-state \(first incl\. compile: \d+\.\d s\)", log)


class Opaque:
    """A pickled object that is not a tensor (what ``weights_only=True`` refuses)."""


@pytest.fixture(scope="module")
def depth_weights(tmp_path_factory):
    """A ``.ckpt`` of the depth graph at 64^2 with counters, holding the JAX
    ``DepthGraph``'s numpy-random variables (the depth head kept inside its
    clamp, so every masked pixel has depth)."""
    opt = config.depth_opt(H)
    jmodel = jgd.DepthGraph.from_opt(opt)
    rgb, mask = config.synthetic_image(H, seed=1)
    batch = {"rgb_input_map": rgb, "mask_input_map": mask, "intr": np.asarray([[[1.3875 * H, 0, H / 2],
                                                                               [0, 1.3875 * H, H / 2], [0, 0, 1]]],
                                                                             np.float32)}
    v = random_variables(jmodel, {k: jnp.asarray(x) for k, x in batch.items()}, train=False, seed=4)
    head = v["params"]["dpt_depth"]["head_conv3"]
    head["kernel"] = head["kernel"] * 1e-2
    head["bias"] = np.full_like(head["bias"], 0.5)
    port = DepthGraph.from_opt(opt)
    weights.load(port, weights.from_flax(v["params"], v["batch_stats"], graph="depth"))
    path = tmp_path_factory.mktemp("ckpt") / "depth.ckpt"
    torch.save({"graph": port.state_dict(), "epoch": 3, "iter": 40, "best_val": 0.25, "best_ep": 2}, path)
    yield path, jmodel, v, port
    os.remove(path)


def _obj_vertices(path):
    with open(path) as f:
        return np.array([[float(x) for x in line.split()[1:]] for line in f if line.startswith("v ")])


def test_demo_depth_task_writes_the_jax_files_and_surfaces(examples, capsys, depth_weights):
    path, jmodel, v, _ = depth_weights
    demo.main([f"--datadir={examples}", "--task=depth", f"--ckpt={path}"] + DEMO)
    log = capsys.readouterr().out
    assert "resuming from epoch 4 (iteration 40, best_val 0.2500)" in log and "==> checkpoint loaded" in log
    names = _names(examples)
    got = sorted(os.listdir(examples / "preds"))
    assert got == _expected(names, DEPTH_FILES), got
    for f in got:
        _check_file(str(examples / "preds" / f))
    samples, _ = demo.prepare_data(demo.options([f"--datadir={examples}", "--task=depth"] + DEMO))
    batch = {k: jnp.asarray(np.concatenate([var[k] for var in samples])) for k in ("rgb_input_map", "mask_input_map",
                                                                                   "intr")}
    # one jitted pass (eager flax takes 4x as long here); eval-mode normalisation: the images do not interact
    out = jax.jit(lambda variables, b: jmodel.apply(variables, b, train=False))(v, batch)
    for b, (name, var) in enumerate(zip(names, samples)):
        m = var["mask_input_map"][0]
        for kind, intr in (("fixed", batch["intr"][b:b + 1]), ("pred", out["intr_pred"][b:b + 1])):
            seen = np.asarray(jcamera.unproj_depth(out["depth_pred"][b:b + 1, ..., 0], intr)).reshape(H, H, 3)
            seen = seen * m + (1 - m) * -1
            want = seen[seen[..., 2] > 0]
            got_v = _obj_vertices(examples / "preds" / f"{name}_seen_surface_{kind}.obj")
            assert got_v.shape == want.shape and len(want) > 100, (got_v.shape, want.shape)
            np.testing.assert_allclose(got_v, want, rtol=0, atol=1e-4 + 5e-5)  # + the 4-decimal print


def test_demo_refuses_a_checkpoint_that_pickles_objects(examples, tmp_path):
    """C3: a reference ``.ckpt`` is read with ``weights_only=True``; an object
    pickled beside the weights is refused, not executed."""
    path = tmp_path / "opaque.ckpt"
    torch.save({"graph": {"intr_proj.weight": torch.zeros(2)}, "opt": Opaque()}, path)
    with pytest.raises(pickle.UnpicklingError):
        demo.main([f"--datadir={examples}", f"--ckpt={path}"] + DEMO)


def test_demo_refuses_a_checkpoint_of_the_other_task(examples, monkeypatch, built, depth_weights):
    """C3: the depth graph's checkpoint given to the shape task raises,
    naming the shape graph's keys the file lacks (the JAX demo reads the
    task's graph, ``load_torch_checkpoint(graph=opt.task)``)."""
    monkeypatch.setattr(recon, "build", built)
    with pytest.raises(ValueError, match=r"depth.ckpt lacks \d+ keys of the graph \(first: \['coord_encoder"):
        demo.main([f"--datadir={examples}", f"--ckpt={depth_weights[0]}"] + DEMO)


# ---------------------------------------------------------------------------
# the train and evaluate CLIs on a tiny tree
# ---------------------------------------------------------------------------

TREE_H = 32
TINY = [f"--image_size=[{TREE_H},{TREE_H}]", "--arch.latent_dim=64", "--arch.impl.n_channels=64",
        "--arch.impl.mlp_layers=4", "--arch.impl.skip_in=[2]", "--arch.depth.n_blocks=2", "--eval.vox_res=16",
        "--eval.num_points=200", "--eval.batch_size=2", "--data.num_workers=2", "--device=cpu", "--seed=0",
        "--data.synthetic.subset=analytic"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree")
    generate_dataset(str(root), n_objects=2, n_views=3, H=TREE_H, seed=0, n_pc_points=300, n_sdf_points=400)
    return root


def _idx(root):
    opt = config.Config({"H": TREE_H, "W": TREE_H, "seed": 0, "training": {"n_sdf_points": 400},
                         "data": {"root": str(root), "synthetic": {"subset": "analytic", "percentage": 1}}})
    return [int(s["idx"]) for s in SyntheticDataset(opt, split="test")]


def _files_of(folder, idx, files):
    """The dump files of samples ``idx`` in ``folder``; a sample's mesh files
    are left out where marching cubes found no surface (both or neither)."""
    got = sorted(os.listdir(folder))
    for i in idx:
        mesh = [f for f in EMPTY_MESH if f"{i}_{f}" in got]
        assert mesh in ([], [f for f in EMPTY_MESH if f in files]), (i, mesh)
    empty = [i for i in idx if f"{i}_mesh.ply" not in got]
    assert got == _expected(idx, files, empty), got
    return empty


class Writer:
    """A TensorBoard writer that records what it is given."""

    def __init__(self):
        self.scalars, self.images = [], []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, step))

    def add_image(self, tag, img, step, dataformats="HWC"):
        self.images.append((tag, step, np.asarray(img).shape, dataformats))

    def flush(self):
        pass


def test_train_cli_and_final_evaluation_write_the_jax_folders(tree, tmp_path, monkeypatch):
    """A 2-epoch shape run of the train CLI (one step an epoch) with
    ``eval.n_vis=2``, ``freq.eval=2`` (validation before the first step and
    after the second epoch), ``freq.save_vis=1`` and ``freq.vis=1`` (TensorBoard
    grids of the batch), then the final evaluation the evaluate CLI runs
    (``shape_engine.evaluate``, in this process: the CLI's own dumps are
    held in ``test_torch_port_evaluate_cli.py``) on the trained weights,
    calibrated so that every sample has a mesh and a turntable. The
    checkpoints are the engine's files for a one-parameter stand-in graph:
    their contents are held in ``test_torch_port_trainer.py``, and the real
    ones (~1.2 GB each, five of them) would take most of this test's time."""
    from zeroshape_tpu_torch.runtime import engine_base, shape_engine

    save, stand_in = engine_base.save_checkpoint, torch.nn.Linear(1, 1)
    monkeypatch.setattr(engine_base, "save_checkpoint", lambda path, graph, optimizer, *a, **k: save(
        path, stand_in, SimpleNamespace(state_dict=dict), *a, **k))

    out = tmp_path / "run"
    args = TINY + [f"--data.root={tree}", f"--output_path={out}", "--batch_size=4", "--max_epoch=2",
                   "--training.n_sdf_points=64", "--optim.fix_dpt", "--freq.print=1", "--freq.vis=1",
                   "--freq.scalar=1000", "--freq.ckpt_latest=1000", "--freq.eval=2", "--eval.n_vis=2",
                   "--freq.save_vis=1"]
    writer = Writer()
    monkeypatch.setattr(engine_base, "scalar_writer", lambda path, enabled: writer)
    try:
        res = train_cli.main(args)
        # shape_engine.py:936-970: four grids of the batch (up to 4 x 8 images) at each step
        tags = ("image_input_map", "mask_input_map", "depth_est_map", "depth_input_map")
        assert writer.images == [(f"train/{t}", it, (TREE_H, 4 * TREE_H, 3), "HWC") for it in (0, 1) for t in tags]
        idx = _idx(tree)
        viz = idx[:: max(len(idx) // 2, 1)][:2]  # engine_base.py:75-86
        assert res["it"] == 2
        top = sorted(os.listdir(out))
        # validations before the first step and after epoch 2 (freq.eval=2): shape_engine.py:694-695, 875-885
        assert top == sorted(["best.ckpt", "checkpoint", "latest.ckpt", "options.yaml", "vis_log", "vis_0", "vis_2",
                              "results_ep0.html", "results_ep2.html"]), top
        assert sorted(os.listdir(out / "vis_log")) == ["iter_0", "iter_1"]  # shape_engine.py:561-568, 929-934
        for folder in ["vis_0", "vis_2", "vis_log/iter_0", "vis_log/iter_1"]:
            _files_of(out / folder, viz, VIZ_FILES)
            for i in viz:
                assert gif.info(str(out / folder / f"{i}_attn.gif"))["frames"] == 6
        html = (out / "results_ep2.html").read_text()
        assert [int(s) for s in re.findall(r"<tr><th>(\d+)</th>", html)] == viz

        shutil.rmtree(out)
        # the trained field lies on one side of 0.5 at vox 16: calibrate it so that the meshes and turntables exist
        opt = evaluate_cli.options(args)
        test = SyntheticDataset(opt, split="test")
        model = recon.ReconModel(res["graph"].eval(), None, 1.0, torch.device("cpu"))
        recon.calibrate_random_field(model, {k: test[0][k][None] for k in ("rgb_input_map", "mask_input_map")},
                                     vox_res=16)
        ev = tmp_path / "eval"
        os.makedirs(ev)
        got = shape_engine.evaluate(model, test, opt, str(ev), test.label2cat, training=False, device="cpu")
        assert sorted(os.listdir(ev)) == sorted(["cd_cat.txt", "synthetic_full_results.txt", "quantitative_synthetic.txt",
                                                 "dump_synthetic", "results_test.html"])
        empty = _files_of(ev / "dump_synthetic", idx, EVAL_FILES)
        assert len(got["acc"]) == len(idx) and not empty
        html = (ev / "results_test.html").read_text()
        assert [int(s) for s in re.findall(r"<tr><th>(\d+)</th>", html)] == sorted(idx)[::10]  # skip_every=10
        assert all(gif.info(str(ev / "dump_synthetic" / f"{i}_mesh_viz.gif"))["frames"] == 15
                   for i in idx if i not in empty)
    finally:
        shutil.rmtree(out, ignore_errors=True)


def test_depth_engine_draws_the_tensorboard_grids(depth_weights):
    """The depth engine's grids at ``freq.vis`` (``depth_engine.py:183-207``):
    the batch's images, masks, the eval-mode depth estimate and the GT depth;
    the graph is left in its training mode."""
    from zeroshape_tpu_torch.runtime import depth_engine

    graph = depth_weights[3].train()
    rng = np.random.default_rng(9)
    f = 1.3875 * H
    batch = {"rgb_input_map": rng.uniform(size=(2, H, H, 3)).astype(np.float32),
             "mask_input_map": (rng.uniform(size=(2, H, H, 1)) > 0.3).astype(np.float32),
             "depth_input_map": rng.uniform(0.5, 1.0, (2, H, H, 1)).astype(np.float32),
             "intr": np.tile(np.array([[f, 0, H / 2], [0, f, H / 2], [0, 0, 1]], np.float32), (2, 1, 1))}
    writer = Writer()
    depth_engine.visualize_train_batch(graph, batch, config.depth_opt(H), writer, 5, torch.device("cpu"))
    tags = ("image_input_map", "mask_input_map", "depth_est_map", "depth_input_map")
    assert writer.images == [(f"train/{t}", 5, (H, 2 * H, 3), "HWC") for t in tags]
    assert graph.training
