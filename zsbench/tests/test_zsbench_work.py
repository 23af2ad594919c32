"""The work arithmetic against FlopCounterMode on the plain reference, and the
peaks' ratios."""

import torch

from zsbench import work
from zsbench.reference.parts import Implicit


def test_decoder_flops_match_the_counter_on_the_reference():
    torch.manual_seed(0)
    impl = Implicit(num_patches=4, latent_dim=32, n_channels=32, n_blocks=2, heads=4, n_hidden=4, skip_in=(2,))
    latent = torch.randn(1, 5, 32)
    kvs = impl.encode(latent)
    pts = torch.randn(1, 100, 3)
    counted, _ = work.no_grad_flops(impl.decode, kvs, pts)
    assert work.decoder_flops(100, 5, C=32, n_blocks=2, hidden=128, n_linears=5, skip_in=(2,)) == counted


def test_config_decoder_flops_is_the_shipped_decoder():
    cfg = {"arch": {"impl": {"n_channels": 256, "att_blocks": 2, "mlp_ratio": 4.0, "mlp_layers": 8,
                             "skip_in": [2, 4, 6]}}}
    per_point = work.config_decoder_flops(1, cfg, 197)
    assert per_point == work.decoder_flops(1, 197)
    assert 4.9e6 < per_point < 5.1e6  # about 5.0 MFLOP a point


def test_points_comparisons_and_rooflines():
    assert work.hier_points(1600) == 33**3 + 125 * 1600
    assert work.hier_points(10**6) == 33**3 + 125 * 4096  # clamped to the capacity
    comparisons = work.chamfer_comparisons(6912, 10000, 10000)
    assert comparisons == 6912 * 2 * 10**8
    assert abs(comparisons / work.PEAK_COMPARISONS - 0.04126567) < 1e-6  # a sample's least time, s
    # compute-bound: the FLOPs' time over the measured time
    assert abs(work.roofline_pct(989e9, 0, 0.002) - 50.0) < 1e-9
    # bandwidth-bound: the bytes' time
    assert abs(work.roofline_pct(0, 3.35e9, 0.004) - 25.0) < 1e-9
