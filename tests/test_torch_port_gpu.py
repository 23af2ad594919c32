"""The fused decoder kernel against its plain version, on the card.

These tests need a CUDA device and skip without one. This file imports
neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py
"""

import numpy as np
import pytest
import torch

from zeroshape_tpu_torch.models.implicit import Implicit
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
