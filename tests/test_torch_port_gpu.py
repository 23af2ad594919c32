"""The kernels against their plain versions, on the card: the fused decoder
(K1) and the Chamfer kernels (K2, K3).

These tests need a CUDA device and skip without one. This file imports
neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py
"""

import numpy as np
import pytest
import torch

from zeroshape_tpu_torch.models.implicit import Implicit
from zeroshape_tpu_torch.ops import chamfer as ch
from zeroshape_tpu_torch.ops import implicit_kernel as ik
from zeroshape_tpu_torch.weights import init_like_flax


def _bf(x):
    return x.to(torch.bfloat16).float()


@pytest.mark.gpu
@pytest.mark.parametrize("n_points", [1, 4999])
def test_kernel_matches_plain_decode(n_points):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(2)
    impl = init_like_flax(Implicit(num_patches=196, latent_dim=256), seed=2)
    with torch.no_grad():
        impl.point_proj.proj.weight.mul_(8.0)
        for prm in impl.parameters():  # the kernel's operands are bf16-valued
            prm.copy_(_bf(prm))
    impl = impl.cuda().eval()
    with torch.no_grad():
        latent = torch.randn(1, 197, 256, generator=g).cuda()
        caches = [(_bf(k), _bf(v)) for k, v in impl.encode(latent)]
        pts = (torch.rand(n_points, 3, generator=g) * 3 - 1.5).cuda()
        got = ik.fused_decode(impl, caches, pts, ik.pack_decoder_params(impl)).cpu().numpy()
        want = impl.decode(caches, pts[None])[0][0].cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=8e-2, atol=2e-2)
    if n_points > 1:
        assert np.corrcoef(got, want)[0, 1] > 0.9999
        assert np.abs(got - want).mean() < 5e-3


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
# the Chamfer kernels K2 and K3 against their plain versions
# ---------------------------------------------------------------------------

def _clouds(B, N, M, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(B, N, 3, generator=g) * 2 - 1).cuda(), (torch.randn(B, M, 3, generator=g) * 0.5).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M", [(2, 64, 64), (3, 1000, 777)])
def test_nn_one_way_kernel_matches_plain(B, N, M):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x1, x2 = _clouds(B, N, M, 3)
    for shared in (False, True):
        b = x2[:1].expand(B, -1, -1) if shared else x2
        launches = ch.nn_one_way.launches
        dist, idx = ch.nn_one_way(x1, b)
        assert ch.nn_one_way.launches == launches + 1
        _, ref_idx = ch._nn_one_way_plain(x1, b)
        ref = ch._refine(x1, b, ref_idx)
        torch.testing.assert_close(dist, ref, rtol=0, atol=1e-5)
        same = idx == ref_idx
        assert float(same.float().mean()) >= 0.999
        # where the argmins differ, the two candidates are equally near
        torch.testing.assert_close(ch._refine(x1, b, idx)[~same], ref[~same], rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M", [(2, 64, 64), (3, 1000, 777)])
def test_nn_min_fast_kernel_matches_plain(B, N, M):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x1, x2 = _clouds(B, N, M, 4)
    launches = ch.nn_min_squared_fast.launches
    got = ch.nn_min_squared_fast(x1, x2)
    assert ch.nn_min_squared_fast.launches == launches + 1
    torch.testing.assert_close(got, ch._nn_min_plain(x1, x2), rtol=0, atol=1e-5)


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
