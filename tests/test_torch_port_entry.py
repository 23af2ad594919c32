"""``zeroshape_tpu_torch.graft_entry`` against ``__graft_entry__``: the shared
fixtures (options key for key, batches bit for bit), the flagship forward at
the tiny size against the JAX ``model.apply`` on the same weights (1e-3 end
to end, tests/test_torch_parity.py's bound), and the dry run over two CPU
ranks: one training step and the dense evaluation, both JAX lines printed,
and a rank that raises taking the run down within its timeout."""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__ as ge
from zeroshape_tpu.models.graph_shape import ShapeGraph as JShapeGraph
from zeroshape_tpu_torch import graft_entry, weights

from test_torch_harness import close, random_variables
from test_torch_harness import few_threads, give_memory_back  # noqa: F401 (autouse: two threads; memory back at the end)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "2"  # one torch thread a rank
    return env


@pytest.mark.parametrize("B, H, n_pts, seed", [(2, 32, 16, 0), (3, 64, 8, 5)])
def test_batch_is_bit_equal_to_the_jax_fixture(B, H, n_pts, seed):
    want = ge._batch(B, H, n_pts, seed)
    got = graft_entry._batch(B, H, n_pts, seed)
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].numpy().dtype == v.dtype and got[k].shape == v.shape, k
        assert np.array_equal(got[k].numpy(), v), k


@pytest.mark.parametrize("ours, theirs", [(graft_entry._full_opt, ge._full_opt), (graft_entry._tiny_opt, ge._tiny_opt)])
def test_options_equal_the_jax_entry_key_for_key(ours, theirs):
    assert ours().to_dict() == theirs().to_dict()
    assert ours(64).to_dict() == theirs(64).to_dict()


def test_entry_forward_matches_jax_model_apply():
    """``entry``'s forward at ``_tiny_opt`` on the JAX variables carried by
    ``weights.from_flax``: ``pred_sample_occ``, ``depth_pred`` and
    ``intr_pred`` within 1e-3 of ``model.apply``."""
    opt = ge._tiny_opt()
    jmodel = JShapeGraph.from_opt(opt)
    jbatch = ge._batch(B=1, H=opt.H, n_pts=opt.training.n_sdf_points)
    v = random_variables(jmodel, jbatch, train=False, seed=3)
    head = v["params"]["dpt_depth"]["head_conv3"]  # keep the random depth head inside its [0, 1] clamp
    head["kernel"] = head["kernel"] * 1e-2
    head["bias"] = np.full_like(head["bias"], 0.5)
    out = jax.jit(lambda v, b: jmodel.apply(v, b, train=False, mutable=False))(v, jbatch)
    want = out["pred_sample_occ"], out["depth_pred"], out["intr_pred"]

    forward, (graph, batch) = graft_entry.entry(device="cpu", opt=graft_entry._tiny_opt())
    weights.load(graph, weights.from_flax(v["params"], v["batch_stats"], impl_blocks=2, impl_mlp_linears=5))
    got = forward(graph.eval(), batch)
    assert got[0].shape == (1, opt.training.n_sdf_points) and got[1].shape == (1, opt.H, opt.W, 1)
    assert float(jnp.std(want[1])) > 1e-3  # a live depth map, not a clamped constant
    for name, g, w in zip(("pred_sample_occ", "depth_pred", "intr_pred"), got, want):
        close(g.numpy(), np.asarray(w), 1e-3, name)


def test_dryrun_on_two_cpu_ranks_prints_the_jax_lines():
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "zeroshape_tpu_torch.graft_entry", "dryrun", "2", "--device=cpu",
                          "--timeout=300"], cwd=REPO, env=_env(), capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert any(x.startswith("dryrun_multichip(2, tiny H=32): loss_all=") and x.endswith(" OK") for x in lines), lines
    assert any(x.startswith("dryrun_multichip(2, tiny H=32) eval: per-sample CD [")
               and x.endswith("over 2 sharded samples OK") for x in lines), lines
    # the tiny decoder is not K1's: each rank decodes its dense grid plainly, once
    assert "dryrun: launches {'K1': 0, 'K2': 0, 'K3': 0, 'plain': 2}" in out.stdout
    assert time.perf_counter() - t0 < 300


FAULTY = """
from zeroshape_tpu_torch import graft_entry


def rank_main(rank, *args):
    if rank == 1:
        raise RuntimeError("planted fault on rank 1")
    graft_entry._rank(rank, *args)
"""


def test_dryrun_exits_non_zero_when_a_rank_raises(tmp_path):
    """Rank 1 raises before it joins the process group; rank 0, waiting for it,
    is taken down and the call raises long before its timeout."""
    (tmp_path / "faulty.py").write_text(FAULTY)
    code = (f"import sys; sys.path.insert(0, {str(tmp_path)!r}); import faulty\n"
            "from zeroshape_tpu_torch import graft_entry\n"
            "graft_entry.dryrun_multichip(2, full=False, device='cpu', timeout=240, rank_fn=faulty.rank_main)\n")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "planted fault on rank 1" in out.stderr
    assert time.perf_counter() - t0 < 240


@pytest.mark.slow
def test_dryrun_on_eight_cpu_ranks_at_full_width():
    """The JAX gate's size: the full 224^2 graph over 8 ranks (8 CPU processes
    of the full DPT; too large beside the JAX dry run in the tier-1 run)."""
    res = graft_entry.dryrun_multichip(8, full=True, device="cpu", timeout=3600)
    assert np.isfinite(res["loss"]) and len(res["cd"]) == 8 and np.isfinite(res["cd"]).all()
