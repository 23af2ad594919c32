"""``python -m zeroshape_tpu_torch.evaluate`` at tiny size on the CPU, on
trees written in each dataset's layout: the JAX package's files
(``data_list.txt`` byte-equal to the JAX dataset's ``id_filename_mapping``,
``{dataset}_full_results.txt``, ``cd_cat.txt`` with a row a category,
``quantitative_{dataset}.txt``; ``best_val.txt`` for the depth task), their
rows equal to the returned metrics at the printed precision, and the weights
of ``--ckpt`` and ``--resume``.
"""

import importlib
import os
import re

import numpy as np
import pytest
import torch

from zeroshape_tpu.config import Config as JConfig
from zeroshape_tpu_torch import evaluate as evaluate_cli
from zeroshape_tpu_torch import weights
from zeroshape_tpu_torch.data.analytic import generate_dataset
from zeroshape_tpu_torch.metrics.depth_metrics import metric_keys
from zeroshape_tpu_torch.runtime import engine_base

from test_torch_harness import data_opt, few_threads, give_memory_back, write_ocrtoc, write_pix3d  # noqa: F401

H = 32
TINY = [f"--image_size=[{H},{H}]", "--arch.latent_dim=64", "--arch.impl.n_channels=64", "--arch.impl.mlp_layers=4",
        "--arch.impl.skip_in=[2]", "--arch.depth.n_blocks=2", "--eval.vox_res=16", "--eval.num_points=200",
        "--eval.batch_size=2", "--data.num_workers=2", "--device=cpu", "--seed=0"]
THRESHOLDS = (0.005, 0.01, 0.02, 0.05, 0.1, 0.2)  # eval.f_thresholds of options/shape.yaml
DATASETS = {"synthetic": "zeroshape_tpu.data.synthetic", "pix3d": "zeroshape_tpu.data.pix3d",
            "ocrtoc": "zeroshape_tpu.data.ocrtoc", "omniobj3d": "zeroshape_tpu.data.omniobj3d"}


@pytest.fixture(scope="module", autouse=True)
def init_once():
    """Draw each graph's seeded weights once (``init_like_flax`` takes ~15 s
    for the full-width encoders) and load them into every run's graph."""
    cache = {}

    def init(graph, seed=0):
        key = (type(graph).__name__, seed)
        if key not in cache:
            cache[key] = {k: v.clone() for k, v in weights.init_like_flax(graph, seed).state_dict().items()}
        graph.load_state_dict(cache[key])
        return graph

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(evaluate_cli, "init_like_flax", init)
        yield


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    generate_dataset(str(root), n_objects=2, n_views=2, H=H, seed=0, n_pc_points=300, n_sdf_points=300,
                     holdout_objects=1)
    write_pix3d(str(root), H=H, cats=("chair", "sofa"), n=2)
    write_ocrtoc(str(root), H=H, cats=("mug",), n=6)
    write_ocrtoc(str(root), "OmniObject3D", "depth", H=H, cats=("mug",), n=3)
    return root


def _check_shape_files(out, dataset, res, label2cat):
    files = sorted(os.listdir(out))
    assert files == sorted(["data_list.txt", "cd_cat.txt", f"{dataset}_full_results.txt",
                            f"quantitative_{dataset}.txt", f"dump_{dataset}", "results_test.html"]), files
    # every sample's dumps (shape_engine.py:778-824): the mesh and its turntable where marching cubes found a surface
    dumps = sorted(os.listdir(out / f"dump_{dataset}"))
    for i in res["idx"]:
        mine = sorted(f[len(f"{i}_"):] for f in dumps if f.split("_")[0] == str(i))
        assert mine in (["depth_est.png", "image_input.png", "mask_input.png", "pointclouds_comp.ply"],
                        ["depth_est.png", "image_input.png", "mask_input.png", "mesh.ply", "mesh_viz.gif",
                         "pointclouds_comp.ply"]), (i, mine)
    assert sorted({int(f.split("_")[0]) for f in dumps}) == sorted(res["idx"].tolist())
    rows = open(out / f"{dataset}_full_results.txt").read().split("\n")
    assert rows[0] == "IND, CD, ACC, COMP, " + ", ".join(f"F-score@{t * 100:.2f}" for t in THRESHOLDS)
    assert len(rows) == len(res["acc"]) + 1
    for i, row in enumerate(rows[1:]):
        cols = row.split("\t")
        assert int(cols[0]) == res["idx"][i] == i
        want = [(res["acc"][i] + res["comp"][i]) / 2, res["acc"][i], res["comp"][i], *res["f_score"][i]]
        np.testing.assert_allclose([float(c) for c in cols[1:]], want, atol=5.1e-5)
    cat = open(out / "cd_cat.txt").read().splitlines()
    assert cat[0] == "CD     Acc    Comp   Count Cat"
    present = [label2cat[i] for i in sorted(set(res["category_label"].tolist()))]
    assert [line.split()[4] for line in cat[1:]] == present
    for line in cat[1:]:
        sel = res["category_label"] == label2cat.index(line.split()[4])
        assert re.fullmatch(r"\d\.\d{4} \d\.\d{4} \d\.\d{4} +\d+ \w+", line) and int(line.split()[3]) == sel.sum()
        assert abs(float(line.split()[1]) - res["acc"][sel].mean()) <= 5.1e-5
    quant = open(out / f"quantitative_{dataset}.txt").read().splitlines()
    assert quant[0] == "CD     Acc    Comp " and abs(float(quant[1].split()[0]) - res["val_metric"]) <= 5.1e-5
    assert [q.split(":")[0] for q in quant[2:]] == [f"F-score @ {t * 100:.2f}" for t in THRESHOLDS]


@pytest.mark.parametrize("dataset, extra, n", [
    ("synthetic", ["--data.synthetic.subset=analytic"], 2 + 2),
    ("pix3d", ["--data.pix3d.cat=chair,sofa"], 4),
    ("ocrtoc", ["--data.ocrtoc.erode_mask=2"], 2),
    ("omniobj3d", [], 3),
])
def test_evaluate_cli_writes_the_jax_files(root, tmp_path, dataset, extra, n):
    out = tmp_path / "out"
    res = evaluate_cli.main(["--task=shape"] + TINY + extra + [f"--data.root={root}", f"--data.dataset_test={dataset}",
                                                             f"--output_path={out}"])
    assert len(res["acc"]) == n and np.isfinite(res["acc"]).all() and np.isfinite(res["comp"]).all()
    jopt = JConfig(data_opt(root, H=H, dataset_test=dataset, pix3d={"cat": "chair,sofa"},
                            ocrtoc={"cat": None, "erode_mask": 2}))
    theirs = importlib.import_module(DATASETS[dataset]).Dataset(jopt, split="test")
    theirs.id_filename_mapping(jopt, str(tmp_path / "want.txt"))
    assert open(out / "data_list.txt").read() == open(tmp_path / "want.txt").read()
    _check_shape_files(out, dataset, res, theirs.label2cat)
    if dataset == "synthetic":
        assert theirs.label2cat == ["ho0", "prim"]


def test_ckpt_and_resume_load_the_weights(root, tmp_path):
    """``--resume`` reads ``output_path``'s ``best.ckpt``, ``--ckpt`` a given
    file: both score the checkpoint's weights, not the initial ones."""
    args = ["--task=shape"] + TINY + [f"--data.root={root}", "--data.synthetic.subset=analytic"]
    initial = evaluate_cli.main(args + [f"--output_path={tmp_path / 'initial'}"])
    opt = evaluate_cli.options(args)
    graph = evaluate_cli.graph_for(opt, torch.device("cpu"))
    with torch.no_grad():
        graph.impl_network.impl_mlp.layers[-1].bias.add_(0.5)  # another surface
    out = tmp_path / "resumed"
    os.makedirs(out)
    engine_base.save_checkpoint(str(out), graph, torch.optim.SGD([torch.zeros(1)], lr=0), 0, 0, 0.0, 0, latest=True,
                                best=True)
    os.remove(out / "latest.ckpt")
    try:
        resumed = evaluate_cli.main(args + [f"--output_path={out}", "--resume"])
        given = evaluate_cli.main(args + [f"--output_path={tmp_path / 'given'}", f"--ckpt={out / 'best.ckpt'}"])
    finally:
        os.remove(out / "best.ckpt")
    np.testing.assert_array_equal(resumed["acc"], given["acc"])
    assert not np.array_equal(resumed["acc"], initial["acc"])


def test_evaluate_cli_depth_task_writes_best_val(root, tmp_path):
    out = tmp_path / "depth"
    means = evaluate_cli.main(["--task=depth"] + TINY + [f"--data.root={root}", "--data.synthetic.subset=analytic",
                                                         f"--output_path={out}"])
    assert sorted(os.listdir(out)) == ["best_val.txt", "data_list.txt", "dump_synthetic"]
    # the first batch's images and depth estimates (depth_engine.py:296-319)
    assert sorted(os.listdir(out / "dump_synthetic")) == [f"{i}_{f}" for i in (0, 1)
                                                          for f in ("depth_est.png", "image_input.png")]
    lines = open(out / "best_val.txt").read().splitlines()
    assert lines == [f"{k}: {means[k]:.6f}" for k in metric_keys()]
