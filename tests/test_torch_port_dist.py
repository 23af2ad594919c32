"""Several processes: one 2-rank gloo launch on the CPU (``torch.distributed.run``,
the launcher behind ``torchrun``) of ``python -m zeroshape_tpu_torch.dist_check``
and, on the same ranks, ``python -m zeroshape_tpu_torch.train``, against the
same runs in one process.

The step's pieces in which rounding is not amplified (``dist_check.parts``:
the intrinsics head's conv-BatchNorm bottlenecks, the coordinate encoder's
first ResNet stage, the decoder with stochastic depth; fp32, global batch 4):
every gradient leaf within 1e-5 of its norm + 1e-7 of the piece's whole
gradient (the bound of ``test_torch_port_train.py``'s parity step), the
outputs within 1e-6 of their norm and the BatchNorm running statistics
within 1e-6, with no allowance for spread.

The whole step (``config.tiny_opt(32)``): the same bounds, each raised to 4x
the one-process step's own spread between 1 and 2 CPU threads where that is
larger, because train-mode BatchNorm deep in the coordinate encoder
amplifies fp32 rounding (the spread reaches ~7e-2 of a leaf's norm at any
image size, batch or input tried); the loss 1e-6. The evaluation (5 samples
at eval batch 2, a padded tail): per-sample metrics within 1e-6 and the
result files identical.

The train CLI on an analytic tree (2 steps of a global batch of 4, a
validation before and after): one log, rank 0 the only writer, the first
loss (the same weights on the same batch) and the first validation within
1e-4 of one rank's, and ``latest.ckpt`` with one rank's tensors: the frozen
depth graph equal, every other parameter within AdamW's reach of one rank's
(3 lr a step; which way an element moves follows its gradient's sign, and
the coordinate encoder's gradients are ill-conditioned as above).
"""

import filecmp
import os
import re
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from zeroshape_tpu_torch import dist_check
from zeroshape_tpu_torch.data.analytic import generate_dataset
from zeroshape_tpu_torch.parallel import dist
from zeroshape_tpu_torch.runtime import engine_base

from test_torch_harness import few_threads, give_memory_back  # noqa: F401 (autouse: two threads; memory back at the end)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ("synthetic_full_results.txt", "cd_cat.txt", "quantitative_synthetic.txt")
H = 32
# the trainer tests' tiny run (tests/test_torch_port_trainer.py) at a global batch of 4: 2 steps of an epoch
TINY = [f"--image_size=[{H},{H}]", "--arch.latent_dim=64", "--arch.impl.n_channels=64", "--arch.impl.mlp_layers=4",
        "--arch.impl.skip_in=[2]", "--arch.depth.n_blocks=2", "--batch_size=4", "--max_epoch=1", "--seed=3",
        "--training.n_sdf_points=64", "--optim.fix_dpt", "--tb=null", "--freq.print=1", "--freq.scalar=1",
        "--freq.ckpt_latest=1000", "--freq.eval=1", "--eval.vox_res=16", "--eval.num_points=200",
        "--eval.batch_size=2", "--data.num_workers=2", "--device=cpu"]
LR = 1e-4  # shape_gen's


def _env():
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "2"
    return env


def _launch(module, args):
    return subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
                             "-m", module] + args, cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The runs' directories: ``one`` (one process), ``one_thread`` (one
    process at 1 thread), ``two`` (two ranks), and the train CLI's
    ``one_train`` and ``two_train``, whose checkpoints go at the end. One
    run after another: the two ranks and their launcher hold ~8 GB, each
    with the full-width encoders of ``tiny_opt``."""
    from zeroshape_tpu_torch import train

    d = {n: tmp_path_factory.mktemp(n) for n in ("data", "one", "one_thread", "two", "one_train", "two_train")}
    generate_dataset(str(d["data"]), n_objects=2, n_views=5, H=H, seed=0, n_pc_points=300, n_sdf_points=400)
    args = TINY + [f"--data.root={d['data']}"]
    launch = _launch("zeroshape_tpu_torch.dist_check", [str(d["two"]), "--device=cpu", "train"] + args
                     + [f"--output_path={d['two_train']}"])
    d["log"], _ = launch.communicate(timeout=600)
    assert launch.returncode == 0, d["log"][-3000:]
    assert "rank 0 of 2: backend gloo, CPU" in d["log"] and "rank 1 of 2: backend gloo, CPU" in d["log"]
    dist_check.main([str(d["one"]), "--device=cpu"])
    dist_check.main([str(d["one_thread"]), "--device=cpu", "--threads=1"])
    d["one_run"] = train.main(args + [f"--output_path={d['one_train']}"])
    yield d
    shutil.rmtree(d["one_train"])
    shutil.rmtree(d["two_train"])


def _load(path, name):
    return torch.load(os.path.join(path, name), weights_only=True)


@pytest.mark.parametrize("piece", ["intr_head", "coord_encoder.encoder.layer1", "impl_network"])
def test_two_rank_pieces_equal_one_rank_pieces(runs, piece):
    ref, got = (torch.load(runs[r] / "parts.pt", weights_only=False)[piece] for r in ("one", "two"))
    bad, bad_bn, within, worst = dist_check.disagreements(ref, got)
    assert not bad and not bad_bn and within == 1.0, (bad[:5], bad_bn[:5], worst)
    assert np.linalg.norm(got["out"] - ref["out"]) <= 1e-6 * np.linalg.norm(ref["out"])
    assert len(ref["grads"]) >= 12 and all(float(g.norm()) > 0 for g in ref["grads"].values())


def test_two_rank_step_equals_one_rank_step(runs):
    ref, spread, got = (_load(runs[r], "step.pt") for r in ("one", "one_thread", "two"))
    bad, bad_bn, within, worst = dist_check.disagreements(ref, got, spread)
    assert not bad and not bad_bn, (bad[:5], bad_bn[:5], worst)
    assert len(got["grads"]) == len(ref["grads"]) > 500 and abs(got["loss"] - ref["loss"]) <= 1e-6 * abs(ref["loss"])


def test_two_rank_evaluation_equals_one_rank(runs):
    one, two = runs["one"], runs["two"]
    ref, got = _load(one, "eval.pt"), _load(two, "eval.pt")
    assert got["idx"].tolist() == list(range(5))
    for k in ("acc", "comp", "f_score"):
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
    for name in FILES:
        assert filecmp.cmp(one / name, two / name, shallow=False), name


def test_two_rank_dumps_hold_each_sample_once(runs):
    """The evaluation's dumps (the final posture, 5 samples at eval batch 2, the
    tail padded): each rank dumps the samples it scored, so the folder holds
    every sample's files once, as one rank writes them; rank 0 writes the
    gallery after the barrier, over every 10th sample."""
    one, two = (sorted(os.listdir(runs[r] / "dump_synthetic")) for r in ("one", "two"))
    assert one == two and sorted({int(f.split("_")[0]) for f in two}) == list(range(5))
    assert {f.split("_", 1)[1] for f in two} >= {"image_input.png", "mask_input.png", "depth_est.png",
                                                  "pointclouds_comp.ply"}
    for r in ("one", "two"):
        html = (runs[r] / "results_test.html").read_text()
        assert re.findall(r"<tr><th>(\d+)</th>", html) == ["0"]
        assert sorted(re.findall(r"<br/>([^<]+)</td>", html)) == sorted(f for f in one if f.startswith("0_")
                                                                         and f.endswith((".png", ".gif")))


def test_process_group_rules(monkeypatch):
    """The backend rule, the even split of a global batch, the no-op outside
    a process group."""
    assert dist.backend_for(local_world=2, cuda_devices=0) == "gloo"
    assert dist.backend_for(local_world=2, cuda_devices=1) == "gloo"  # two ranks would share a card
    assert dist.backend_for(local_world=4, cuda_devices=4) == "nccl"
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert dist.init_distributed_from_env() is False and not dist.initialized()
    assert (dist.rank(), dist.world(), dist.is_main(), dist.local_batch(6)) == (0, 1, True, 6)
    rows = {"a": np.arange(3.0)}
    assert dist.gather_rows(rows)["a"].tolist() == [0.0, 1.0, 2.0]
    assert dist.mean_over_ranks({"x": 2.0}) == {"x": 2.0}
    monkeypatch.setattr(dist, "world", lambda: 4)
    with pytest.raises(ValueError, match="must divide evenly over 4 processes"):
        dist.local_batch(6)


def test_gloo_collectives_in_one_process_group(monkeypatch):
    """gather, mean and the bucketed gradient average over a 1-rank gloo group
    (with ``world`` then taken as 2, the average halves every tensor, bucket
    by bucket and dtype by dtype)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        got = dist.gather_rows({"a": np.arange(4, dtype=np.int64), "b": np.ones((4, 2), np.float32)})
        assert got["a"].tolist() == [0, 1, 2, 3] and got["b"].shape == (4, 2)
        assert dist.mean_over_ranks({"x": 3.0, "y": -1.0}) == {"x": 3.0, "y": -1.0}
        grads = [torch.arange(6.0).reshape(2, 3), torch.ones(5, dtype=torch.float64), torch.full((3,), 4.0),
                 torch.full((2,), 8.0)]
        want = [g / 2 for g in grads]
        dist.average_gradients(grads)  # world 1: unchanged
        assert grads[0].tolist() == [[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]]
        monkeypatch.setattr(dist, "world", lambda: 2)
        monkeypatch.setattr(dist, "BUCKET_BYTES", 16)
        dist.average_gradients(grads)
        for g, w in zip(grads, want):
            assert torch.equal(g, w)
    finally:
        torch.distributed.destroy_process_group()


def test_only_rank_zero_writes(tmp_path, monkeypatch):
    monkeypatch.setattr(dist, "rank", lambda: 1)
    graph = torch.nn.Linear(2, 2)
    assert engine_base.save_checkpoint(str(tmp_path), graph, torch.optim.SGD(graph.parameters(), lr=0), 0, 1, 0.5, 1,
                                       latest=True, best=True) is None
    assert engine_base.scalar_writer(str(tmp_path), True) is None
    (tmp_path / "x.tfevents.1").write_text("")
    engine_base.clear_event_files(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["x.tfevents.1"]


def test_train_cli_on_two_ranks_follows_one(runs):
    """``train`` on two ranks after ``dist_check`` in the same launch, against
    one rank's run of the same arguments: 2 steps of the 8 training views at a
    global batch of 4, validations before and after."""
    one, two = runs["one_run"], torch.load(runs["two"] / "train.pt", weights_only=False)
    log = runs["log"][runs["log"].index("TRAINING START"):]  # after dist_check's own evaluation
    assert log.count("TRAINING START") == log.count("TRAINING DONE") == 1 and log.count("CD. ACC") == 2  # rank 0 logs
    assert two["it"] == one["it"] == 2 and len(two["losses"]) == 2 and np.isfinite(two["losses"]).all()
    assert abs(two["losses"][0] - one["losses"][0]) <= 1e-4 * one["losses"][0], (two["losses"], one["losses"])
    assert [e for e, _ in two["val"]] == [0, 1] and abs(two["val"][0][1] - one["val"][0][1]) <= 1e-4 * one["val"][0][1]
    # with rank 0's visual dumps: vis_{ep} and its gallery at each validation, vis_log/iter_0 at the save_vis cadence
    assert sorted(os.listdir(runs["two_train"])) == ["best.ckpt", "checkpoint", "latest.ckpt", "options.yaml",
                                                     "results_ep0.html", "results_ep1.html", "vis_0", "vis_1", "vis_log"]
    assert sorted(os.listdir(runs["two_train"] / "vis_0")) == sorted(os.listdir(runs["one_train"] / "vis_0"))
    a, b = (torch.load(runs[r] / "latest.ckpt", weights_only=True, mmap=True) for r in ("one_train", "two_train"))
    assert (b["iter"], b["best_ep"]) == (a["iter"], a["best_ep"]) == (2, 1)
    assert a["graph"].keys() == b["graph"].keys()
    for k, v in a["graph"].items():
        w = b["graph"][k]
        assert w.shape == v.shape and w.dtype == v.dtype, k
        if k.startswith("dpt_depth"):  # frozen by --optim.fix_dpt on every rank
            assert torch.equal(w, v), k
        elif v.is_floating_point() and "running" not in k:
            assert float((w.float() - v.float()).abs().max()) <= 3 * LR * one["it"], k
