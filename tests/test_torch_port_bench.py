"""``zeroshape_tpu_torch.bench`` and ``zeroshape_tpu_torch.mfu`` against the JAX
``bench.py`` and ``scripts/mfu.py``.

FLOP accounting is pinned on hand-countable programs (tests/test_mfu.py's
cases: a matmul is 2MKN, the count scales with the batch; and a
convolution), the plain decoder's count is ``mfu.decoder_flops`` exactly,
and the tiny graph's forward is held to XLA's cost analysis of the same JAX
forward: XLA also costs elementwise work and counts the graph's matmuls and
convolutions slightly differently, and the port's count measured 1.069x
XLA's at 32^2 (1.041x at 64^2), so the ratio is held to [0.95, 1.15].
The headline's set-up equals ``recon.synthetic_setup``'s; checkpoints and
the real sample are found as the JAX bench finds them; measuring needs the
card."""

import os
import sys
import types

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from zeroshape_tpu.models.graph_shape import ShapeGraph as JShapeGraph
from zeroshape_tpu_torch import bench, config, graft_entry, mfu, recon
from zeroshape_tpu_torch.data.analytic import generate_dataset
from zeroshape_tpu_torch.models.implicit import Implicit

from test_torch_harness import few_threads, give_memory_back, random_variables  # noqa: F401 (autouse: two threads; memory back at the end)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

from mfu import _flops_fallback_cpu  # noqa: E402


def test_matmul_flops_match_hand_count():
    M, K, N = 64, 128, 256
    assert mfu.count_flops(torch.matmul, torch.ones(M, K), torch.ones(K, N)) == 2 * M * K * N


def test_flops_scale_with_batch():
    w = torch.ones(128, 128)
    f1 = mfu.count_flops(torch.matmul, torch.ones(32, 128), w)
    f2 = mfu.count_flops(torch.matmul, torch.ones(64, 128), w)
    assert f2 == 2 * f1


def test_conv_flops_match_hand_count():
    N, C, O, H, k = 2, 8, 16, 12, 3
    conv = torch.nn.Conv2d(C, O, k, padding=1, bias=False)
    expect = 2 * N * O * H * H * C * k * k
    assert mfu.count_flops(conv, torch.ones(N, C, H, H)) == expect


@pytest.mark.parametrize("P", [1, 300])
def test_plain_decode_count_is_decoder_flops(P):
    impl = Implicit(num_patches=196, latent_dim=256).eval()
    with torch.inference_mode():
        caches = impl.encode(torch.randn(1, 197, 256))
        got = mfu.count_flops(impl.decode, caches, torch.rand(1, P, 3))
    want = mfu.decoder_flops(P, 197)
    assert abs(got - want) <= 0.01 * want, (got, want)


def test_tiny_forward_count_against_xla_cost_analysis():
    opt = ge._tiny_opt()
    jmodel = JShapeGraph.from_opt(opt)
    jbatch = ge._batch(1, opt.H, 32)
    v = random_variables(jmodel, jbatch, train=False, seed=0)
    xla, src = _flops_fallback_cpu(lambda v, b: jmodel.apply(v, b, train=False, mutable=False), v, jbatch)
    assert src == "cpu-lowered cost_analysis"
    forward, (graph, _) = graft_entry.entry(device="cpu", opt=graft_entry._tiny_opt())
    ours = mfu.count_flops(forward, graph, graft_entry._batch(1, opt.H, 32))
    assert 0.95 <= ours / xla <= 1.15, (ours, xla, ours / xla)


@pytest.fixture(scope="module")
def tiny_bench():
    """``bench.build``'s headline set-up at the tiny size on the CPU."""
    return bench.build(device="cpu", opt=config.tiny_opt(32))


def test_recon_flops_count_the_plain_decoder_and_refuse_k1(tiny_bench):
    _, model, batch = tiny_bench
    total, dec, points, keys = mfu.recon_flops(bench.variant(model, False), batch, torch.Generator().manual_seed(0))
    assert points == 33**3 + 4096 * 125 and keys == 5  # the coarse lattice, the capacity's cells; 2^2 patches + cls
    assert dec == mfu.decoder_flops(points, keys, C=64, hidden=256, n_linears=5, skip_in=(2,))
    assert total > dec
    full = Implicit(num_patches=196, latent_dim=256)  # the decoder K1 is built for
    k1 = recon.ReconModel(types.SimpleNamespace(impl_network=full), None, 1.0, torch.device("cpu"))
    with pytest.raises(ValueError, match="invisible"):
        mfu.recon_flops(k1, batch, None)


def test_build_reconstructs_as_the_main_path_setup(tiny_bench):
    """The headline's model and image are ``recon.synthetic_setup``'s: the same
    reconstruction from the same generator seed (at vox 32, to be quick)."""
    reconstruct, model, batch = tiny_bench
    ref, ref_batch, _, _ = recon.synthetic_setup("cpu", opt=config.tiny_opt(32))
    assert np.array_equal(batch["rgb_input_map"], ref_batch["rgb_input_map"])
    got = reconstruct(model, batch, torch.Generator().manual_seed(0), vox_res=32)
    want = recon.reconstruct(ref, ref_batch, torch.Generator().manual_seed(0), vox_res=32)
    assert model.sharpen == recon.SHARPEN and int(got[3].max()) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_find_ckpt_order(tmp_path, monkeypatch):
    paths = [tmp_path / f"run{i}" / "best.ckpt" for i in range(3)]
    monkeypatch.setattr(bench, "_CKPT_CANDIDATES", [str(p) for p in paths])
    monkeypatch.delenv("BENCH_CKPT", raising=False)
    assert bench._find_ckpt() is None
    for p in paths[1:]:
        p.parent.mkdir()
        p.write_bytes(b"")
    assert bench._find_ckpt() == str(paths[1])
    mine = tmp_path / "mine.ckpt"
    monkeypatch.setenv("BENCH_CKPT", str(mine))
    assert bench._find_ckpt() is None  # an override that is missing is not replaced by a candidate
    mine.write_bytes(b"")
    assert bench._find_ckpt() == str(mine)


def test_real_sample_matches_the_jax_bench(tmp_path, monkeypatch):
    import bench as jbench

    H = 32
    generate_dataset(str(tmp_path), n_objects=1, n_views=2, H=H, seed=0, n_pc_points=64, n_sdf_points=64)
    monkeypatch.setenv("BENCH_DATA", str(tmp_path))
    want = jbench._real_sample(H)
    got = bench._real_sample(H)
    assert want is not None and set(got) == set(want)
    for k in want:
        assert got[k].shape == (1, H, H, want[k].shape[-1])
        assert np.abs(got[k] - np.asarray(want[k])).max() <= 3 / 255, k
    monkeypatch.setenv("BENCH_DATA", str(tmp_path / "missing"))
    if not os.path.isdir("/tmp/gen_data/train_data"):
        assert bench._real_sample(H) is None


@pytest.mark.parametrize("main", [bench.main, mfu.main])
def test_measuring_needs_the_card(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])
