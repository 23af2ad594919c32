"""The kernels against their plain versions, on the card: the fused decoder
(K1) and the Chamfer kernels (K2, K3); the decode chosen by the decoder's
shapes (a narrow decoder trains, validates, reconstructs and evaluates
through the plain decode; the shipped one only through K1); and a training
step on the card against the same step on the CPU, which launches none of
the kernels; the headline benchmark's last line and its K1 launches.

These tests need a CUDA device and skip without one. This file imports
neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py
"""

import copy
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from zeroshape_tpu_torch.models.implicit import Implicit
from zeroshape_tpu_torch.ops import chamfer as ch
from zeroshape_tpu_torch.ops import implicit_kernel as ik
from zeroshape_tpu_torch.weights import init_like_flax


def _bf(x):
    return x.to(torch.bfloat16).float()


def _decoder(seed, n_latent=197):
    """A full-width decoder with bf16-valued weights (the kernel's operands),
    its packing and bf16-valued caches, on the card."""
    g = torch.Generator().manual_seed(seed)
    impl = init_like_flax(Implicit(num_patches=n_latent - 1, latent_dim=256), seed=seed)
    with torch.no_grad():
        impl.point_proj.proj.weight.mul_(8.0)
        for prm in impl.parameters():
            prm.copy_(_bf(prm))
    impl = impl.cuda().eval()
    with torch.no_grad():
        latent = torch.randn(1, n_latent, 256, generator=g).cuda()
        caches = [(_bf(k), _bf(v)) for k, v in impl.encode(latent)]
    return impl, caches, ik.pack_decoder_params(impl), g


# 127, 128, 129 points straddle the kernel's 128-point tile; 4,999 ends in a ragged one
@pytest.mark.gpu
@pytest.mark.parametrize("n_points", [1, 127, 128, 129, 4999])
def test_kernel_matches_plain_decode(n_points):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    impl, caches, packed, g = _decoder(2)
    with torch.no_grad():
        pts = (torch.rand(n_points, 3, generator=g) * 3 - 1.5).cuda()
        got = ik.fused_decode(impl, caches, pts, packed).cpu().numpy()
        want = impl.decode(caches, pts[None])[0][0].cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=8e-2, atol=2e-2)
    if n_points > 1:
        assert np.corrcoef(got, want)[0, 1] > 0.9999
        assert np.abs(got - want).mean() < 5e-3


@pytest.mark.gpu
@pytest.mark.parametrize("n_latent", [1, 17, 50])
def test_kernel_matches_plain_decode_at_other_latent_counts(n_latent):
    """The score mask holds for other L than 197 (a square patch grid + 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    impl, caches, packed, g = _decoder(3, n_latent)
    with torch.no_grad():
        pts = (torch.rand(1000, 3, generator=g) * 3 - 1.5).cuda()
        got = ik.fused_decode(impl, caches, pts, packed).cpu().numpy()
        want = impl.decode(caches, pts[None])[0][0].cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=8e-2, atol=2e-2)
    assert np.abs(got - want).mean() < 5e-3


@pytest.mark.gpu
def test_kernel_is_deterministic_and_row_independent():
    """Two launches on the same points give bit-equal logits, and a point's
    logit does not depend on the tile or row it lands in."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    impl, caches, packed, g = _decoder(4)
    with torch.no_grad():
        pts = (torch.rand(70_000, 3, generator=g) * 3 - 1.5).cuda()
        first = ik.fused_decode(impl, caches, pts, packed)
        second = ik.fused_decode(impl, caches, pts, packed)
        rolled = ik.fused_decode(impl, caches, torch.roll(pts, 37, 0), packed)
    assert torch.equal(first, second)
    assert torch.equal(rolled, torch.roll(first, 37, 0))


@pytest.mark.gpu
def test_dense_sampler_repeats_on_the_card():
    """One seed draws the same surface points twice: the area CDF is summed
    in a fixed order (torch.cumsum of a 1-D CUDA tensor is not)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from zeroshape_tpu_torch.ops.marching_cubes import sample_surface_points

    g = torch.linspace(-1.5, 1.5, 129, device="cuda")
    X, Y, Z = torch.meshgrid(g, g, g, indexing="ij")
    level = torch.sigmoid(8 * (0.9 - torch.sqrt(X**2 + 2 * Y**2 + (Z - 0.2) ** 2)))
    draws = [sample_surface_points(level, torch.Generator(device="cuda").manual_seed(0)) for _ in range(2)]
    assert torch.equal(*draws)


@pytest.mark.gpu
def test_kernel_rejects_bad_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    impl = Implicit(num_patches=196, latent_dim=256).cuda().eval()
    with torch.no_grad():
        caches = impl.encode(torch.randn(1, 197, 256, device="cuda"))
        packed = ik.pack_decoder_params(impl)
        with pytest.raises(ValueError):
            ik.fused_decode(impl, caches, torch.zeros(8, 3, device="cuda", dtype=torch.float64), packed)
        with pytest.raises(ValueError):
            ik.fused_decode(impl, caches, torch.zeros(8, 3, device="cuda"))


# ---------------------------------------------------------------------------
# the decode chosen by the decoder's shapes (K1, or the plain decode)
# ---------------------------------------------------------------------------

# the trainer tests' tiny run (tests/test_torch_port_trainer.py), on the card
TINY_H = 32
TINY = [f"--image_size=[{TINY_H},{TINY_H}]", "--arch.latent_dim=64", "--arch.impl.n_channels=64",
        "--arch.impl.mlp_layers=4", "--arch.impl.skip_in=[2]", "--arch.depth.n_blocks=2", "--batch_size=2",
        "--max_epoch=2", "--seed=3", "--training.n_sdf_points=64", "--optim.fix_dpt", "--tb=null", "--freq.print=1",
        "--freq.scalar=1", "--freq.ckpt_latest=3", "--eval.vox_res=16", "--eval.num_points=200", "--freq.eval=1"]


def _counts():
    from zeroshape_tpu_torch.recon import decode_points

    return ik.fused_decode.launches, ch.nn_one_way.launches, decode_points.plain_decodes


@pytest.mark.gpu
def test_tiny_decoder_trains_and_validates_on_the_card(tmp_path):
    """A decoder K1 is not built for (C=64) trains and validates on the card:
    its validations and train-split metrics decode plainly, score through K2
    and launch no K1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from zeroshape_tpu_torch.data.analytic import generate_dataset
    from zeroshape_tpu_torch.train import main as train_main

    generate_dataset(str(tmp_path / "data"), n_objects=2, n_views=3, H=TINY_H, seed=0, n_pc_points=300,
                     n_sdf_points=400)
    before = _counts()
    res = train_main(TINY + [f"--data.root={tmp_path / 'data'}", f"--output_path={tmp_path / 'run'}"])
    torch.cuda.synchronize()
    k1, k2, plain = (a - b for a, b in zip(_counts(), before))
    assert res["it"] == 4 and np.isfinite(res["losses"]).all()
    assert [ep for ep, _ in res["val"]] == [0, 1, 2] and np.isfinite([cd for _, cd in res["val"]]).all()
    # 3 validations of 2 samples at eval batch 1 and the train-split metrics of
    # 4 steps (1 sample each), a dense decode each
    assert k1 == 0 and k2 > 0 and plain == 3 * 2 + 4


@pytest.mark.gpu
def test_tiny_decoder_reconstructs_and_evaluates_on_the_card(tmp_path):
    """``recon.build`` of a narrow decoder packs nothing, and it reconstructs
    and evaluates (dense final posture) through the plain decode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from zeroshape_tpu_torch import config, recon
    from zeroshape_tpu_torch.data import analytic
    from zeroshape_tpu_torch.runtime import shape_engine

    model = recon.build(config.tiny_opt(TINY_H))
    assert model.packed is None
    rgb, mask = config.synthetic_image(TINY_H, seed=1)
    before = _counts()
    world, *_ = recon.reconstruct(model, {"rgb_input_map": rgb, "mask_input_map": mask}, vox_res=16, num_points=300)
    samples = analytic.eval_samples(2, 2, TINY_H, n_pc_points=300)
    res = shape_engine.evaluate(model, samples, config.eval_opt(config.tiny_opt(TINY_H), vox_res=16, num_points=300),
                                str(tmp_path), ["prim"])
    torch.cuda.synchronize()
    k1, k2, plain = (a - b for a, b in zip(_counts(), before))
    assert tuple(world.shape) == (300, 3) and torch.isfinite(world).all()
    assert np.isfinite(res["val_metric"]) and os.listdir(tmp_path)
    assert k1 == 0 and k2 > 0 and plain == 2 + 1  # reconstruct: coarse + fine; evaluate: one dense batch


@pytest.mark.gpu
def test_shipped_decoder_decodes_through_the_kernel_only():
    """The shipped decoder packs, and every decode launches K1 once a sample,
    never the plain decode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from zeroshape_tpu_torch.recon import decode_points

    impl, caches, packed, g = _decoder(5)
    model = types.SimpleNamespace(graph=types.SimpleNamespace(impl_network=impl), packed=packed)
    before = _counts()
    with torch.inference_mode():
        pts = (torch.rand(2, 500, 3, generator=g) * 3 - 1.5).cuda()
        two = [(torch.cat([k, k]), torch.cat([v, v])) for k, v in caches]
        got = decode_points(model, two, pts)
        want = impl.decode(caches, pts[1:])[0][0]
    torch.cuda.synchronize()
    k1, _, plain = (a - b for a, b in zip(_counts(), before))
    assert (k1, plain) == (2, 0)
    np.testing.assert_allclose(got[1].cpu().numpy(), want.cpu().numpy(), rtol=8e-2, atol=2e-2)


@pytest.mark.gpu
def test_semantic_variant_reconstructs_through_the_kernel():
    """A small semantic graph (both transformer encoders with 2 blocks at
    64^2, the decoder at K1's width: L = 17 latent keys) packs, reconstructs
    with two K1 launches and no plain decode, and K1's logits of its caches
    agree with the plain fp32 decode (the decoder's weights bf16-valued and
    its point embedding strengthened, as :func:`_decoder` makes them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from zeroshape_tpu_torch import config, recon

    opt = config.encoders_opt(64)
    opt.arch.depth.n_blocks = opt.arch.rgb.n_blocks = 2
    model = recon.build(opt)
    impl = model.graph.impl_network
    with torch.no_grad():
        impl.point_proj.proj.weight.mul_(8.0)
        for prm in impl.parameters():
            prm.copy_(_bf(prm))
    model.repack()
    assert model.packed is not None and impl.semantic
    rgb, mask = config.synthetic_image(64, seed=1)
    batch = {"rgb_input_map": rgb, "mask_input_map": mask}
    with torch.inference_mode():
        caches = model.graph.encode_latents(model.graph.encode_image(recon._inputs(batch, model.device)))
        assert caches[0][0].shape[2] == 17
        pts = torch.rand(2000, 3, device="cuda", generator=torch.Generator(device="cuda").manual_seed(1)) * 3 - 1.5
        got = ik.fused_decode(impl, caches, pts, model.packed).cpu().numpy()
        plain = copy.deepcopy(impl)
        plain.dtype = torch.float32
        want = plain.decode([(k.float(), v.float()) for k, v in caches], pts[None])[0][0].cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=8e-2, atol=2e-2)
    assert np.corrcoef(got, want)[0, 1] > 0.9999 and np.abs(got - want).mean() < 5e-3
    recon.calibrate_random_field(model, batch, target=40, vox_res=16)
    before = _counts()
    world, *_ = recon.reconstruct(model, batch, torch.Generator(device="cuda").manual_seed(0), vox_res=16,
                                  capacity=64, num_points=300)
    torch.cuda.synchronize()
    k1, _, n_plain = (a - b for a, b in zip(_counts(), before))
    assert (k1, n_plain) == (2, 0)
    assert tuple(world.shape) == (300, 3) and torch.isfinite(world).all()


# ---------------------------------------------------------------------------
# the Chamfer kernels K2 and K3 against their plain versions
# ---------------------------------------------------------------------------

def _clouds(B, N, M, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(B, N, 3, generator=g) * 2 - 1).cuda(), (torch.randn(B, M, 3, generator=g) * 0.5).cuda()


# shapes a tile-based kernel gets wrong: M = 1, N = 1, N and M off the 16-row
# mma tile, the 128-row block, the 64-column slice, the 128-column argmin
# chunk and the 512-column stage
RAGGED = [(2, 64, 64), (3, 1000, 777), (2, 17, 1), (2, 1, 7), (2, 7, 17), (1, 777, 1000), (2, 129, 513)]


def _operands(x1, x2, shared):
    """The clouds as the paths give them: a cloud shared by the batch is an
    ``expand`` of one (batch stride 0), on either side."""
    B = x1.shape[0]
    if shared == "A":
        return x1[:1].expand(B, -1, -1), x2
    if shared == "B":
        return x1, x2[:1].expand(B, -1, -1)
    return x1, x2


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M", RAGGED)
def test_nn_one_way_kernel_matches_plain(B, N, M):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x1, x2 = _clouds(B, N, M, 3)
    for shared in (None, "A", "B"):
        a, b = _operands(x1, x2, shared)
        launches = ch.nn_one_way.launches
        dist, idx = ch.nn_one_way(a, b)
        assert ch.nn_one_way.launches == launches + 1
        _, ref_idx = ch._nn_one_way_plain(a, b)
        ref = ch._refine(a, b, ref_idx)
        torch.testing.assert_close(dist, ref, rtol=0, atol=1e-5)
        same = idx == ref_idx
        assert float(same.float().mean()) >= 0.999
        # where the argmins differ, the two candidates are equally near
        torch.testing.assert_close(ch._refine(a, b, idx)[~same], ref[~same], rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_nn_one_way_kernel_takes_the_lower_index_of_duplicates():
    """Point j and j + 500 of B coincide: every argmin is below 500, as the
    plain version's first index on ties."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x1, x2 = _clouds(2, 1000, 500, 5)
    dup = torch.cat([x2, x2], dim=1)
    _, idx = ch.nn_one_way(x1, dup)
    _, ref_idx = ch._nn_one_way_plain(x1, dup)
    assert int(idx.max()) < 500 and int(ref_idx.max()) < 500
    assert float((idx == ref_idx).float().mean()) >= 0.999


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M", RAGGED)
def test_nn_min_fast_kernel_matches_plain(B, N, M):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x1, x2 = _clouds(B, N, M, 4)
    for shared in (None, "A", "B"):
        a, b = _operands(x1, x2, shared)
        launches = ch.nn_min_squared_fast.launches
        got = ch.nn_min_squared_fast(a, b)
        assert ch.nn_min_squared_fast.launches == launches + 1
        torch.testing.assert_close(got, ch._nn_min_plain(a, b), rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("fn", [ch.nn_one_way, ch.nn_min_squared_fast])
def test_chamfer_kernels_reject_bad_operands(fn):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.zeros(2, 8, 3, device="cuda")
    with pytest.raises(ValueError):
        fn(x.double(), x.double())
    with pytest.raises(ValueError):
        fn(x, x.cpu())
    with pytest.raises(ValueError):
        fn(x, torch.zeros(3, 8, 3, device="cuda"))
    with pytest.raises(ValueError):
        fn(x, torch.zeros(2, 0, 3, device="cuda"))


@pytest.mark.gpu
def test_train_step_on_the_card_matches_the_cpu_and_launches_no_kernel():
    """``chip_smoke.tiny_step_case``'s fp32 step, TF32 off, on the card and on
    the CPU (and on one CPU thread, for the CPU's own spread), held to
    ``chip_smoke.step_disagreements``: losses, each module's and each
    parameter's gradient, the update and the BatchNorm statistics. No K1, K2
    or K3 launch (the step decodes with the plain decoder, which has a
    backward)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import step_disagreements, step_on, tiny_step_case

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt, graph, batch, masks = tiny_step_case()
    cpu = step_on("cpu", opt, graph, batch, masks)
    cpu_1 = step_on("cpu", opt, graph, batch, masks, threads=1)
    before = (ik.fused_decode.launches, ch.nn_one_way.launches, ch.nn_min_squared_fast.launches)
    card = step_on("cuda", opt, graph, batch, masks)
    torch.cuda.synchronize()
    assert (ik.fused_decode.launches, ch.nn_one_way.launches, ch.nn_min_squared_fast.launches) == before
    bad, _ = step_disagreements(opt, graph, cpu, card, cpu_1)
    assert not bad, bad[:10]


@pytest.mark.gpu
def test_bench_prints_the_headline_line_and_launches_k1_twice():
    """``python -m zeroshape_tpu_torch.bench``: its last line is the headline
    JSON with exactly the four keys of the JAX bench, and the line before
    names the card and K1's 2 launches a reconstruction."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-m", "zeroshape_tpu_torch.bench"], cwd=repo, capture_output=True,
                         text=True, timeout=900, env=dict(os.environ, BENCH_REPS="3"))
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    line = json.loads(lines[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert (line["metric"], line["unit"]) == ("shape_recon_latency_vox128", "s/image")
    # vs_baseline is 1 / the unrounded median; value is that median to 4 decimals
    assert 0 < line["value"] < 10 and abs(line["vs_baseline"] * line["value"] - 1) < 2e-3
    card = [x for x in lines if x.startswith("bench: card ")]
    assert len(card) == 1 and "K1 launches a reconstruction 2;" in card[0], lines
