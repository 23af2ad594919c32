"""The random-init floor's checkpoint and ``measure_hier``'s CLI on it:
``python -m zeroshape_tpu_torch.save_random_init`` at tiny size writes
``best.ckpt`` holding ``init_like_flax(seed)``'s tensors bit for bit, which
the evaluate CLI's loader reads with no key missing and the JAX importer
(``zeroshape_tpu/runtime/checkpoint.py``) converts with nothing missing or
left over; ``measure_hier`` loads it and swaps the same file in through
``--extra_ckpts``, counting the same cells twice. The checkpoints are
deleted afterwards (~0.8 GB each at this size).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from zeroshape_tpu.runtime.checkpoint import load_torch_checkpoint
from zeroshape_tpu_torch import evaluate as evaluate_cli
from zeroshape_tpu_torch import measure_hier, save_random_init
from zeroshape_tpu_torch.data.analytic import generate_dataset
from zeroshape_tpu_torch.models.graph_shape import ShapeGraph
from zeroshape_tpu_torch.runtime import checkpoint
from zeroshape_tpu_torch.train import options
from zeroshape_tpu_torch.weights import init_like_flax

from test_torch_harness import few_threads, give_memory_back  # noqa: F401

H, SEED = 32, 5
TINY = [f"--image_size=[{H},{H}]", "--arch.latent_dim=64", "--arch.impl.n_channels=64", "--arch.impl.mlp_layers=4",
        "--arch.impl.skip_in=[2]", "--arch.depth.n_blocks=2", "--device=cpu", f"--seed={SEED}", "--task=shape"]


@pytest.fixture(scope="module")
def floor(tmp_path_factory):
    root = tmp_path_factory.mktemp("runs")
    try:
        path = save_random_init.main(TINY + ["--name=shape_gen_rand", f"--output_root={root}"])
        yield root, path
    finally:
        shutil.rmtree(root)


def test_save_random_init_writes_the_seeded_init_that_both_importers_read(floor, capsys):
    root, path = floor
    assert path == os.path.join(str(root), "shape", "shape_gen_rand", "best.ckpt") and os.path.isfile(path)
    opt = options(TINY, safe_check=False)
    want = init_like_flax(ShapeGraph.from_opt(opt), SEED).state_dict()
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    assert set(ckpt) == {"graph", "epoch", "iter", "best_val", "best_ep", "optim"}
    assert (ckpt["epoch"], ckpt["iter"], ckpt["best_ep"]) == (0, 0, 0) and ckpt["best_val"] == float("inf")
    assert set(ckpt["graph"]) == set(want)
    for k, v in want.items():
        assert torch.equal(ckpt["graph"][k], v), k
    # the evaluate CLI's --ckpt: every key of the graph is in the file
    capsys.readouterr()
    graph = evaluate_cli.graph_for(options(TINY + [f"--ckpt={path}"], safe_check=False), torch.device("cpu"))
    assert "missing" not in capsys.readouterr().out
    sd, meta, layout = checkpoint.load_reference_ckpt(path)
    assert layout == "graph" and [k for k in checkpoint._expected(graph) if k not in sd] == []
    for k, v in graph.state_dict().items():
        assert torch.equal(v, want[k]), k
    params, stats, report, meta = load_torch_checkpoint(path, graph="shape", impl_mlp_linears=5)
    assert report["missing"] == [] and report["unconsumed"] == []
    assert meta["epoch"] == 0 and params["impl_network"] and stats["coord_encoder"]


def test_measure_hier_cli_swaps_the_extra_checkpoint_in(floor, tmp_path, capsys):
    root, path = floor
    data = tmp_path / "data"
    generate_dataset(str(data), n_objects=2, n_views=2, H=H, seed=0, n_pc_points=200, n_sdf_points=200,
                     holdout_objects=1)
    out = measure_hier.main(TINY + [f"--data.root={data}", f"--output_root={root}", "--name=shape_gen_rand",
                                    "--resume", f"--extra_ckpts={path}", "--eval.vox_res=32",
                                    "--eval.num_points=100", "--eval.batch_size=2", "--data.num_workers=0"])
    assert list(out) == ["shape_gen_rand"] and len(out["shape_gen_rand"]) == 2 + 2  # 2 seen + 2 held-out views
    printed = capsys.readouterr().out
    assert f"swapping weights to {path}" in printed and "[shape_gen_rand] n_active: min=" in printed
    assert printed.count("capacity 2048:") == printed.count("capacity 4096:") == 2
    counts = out["shape_gen_rand"]
    assert np.all((counts >= 0) & (counts <= 512))
