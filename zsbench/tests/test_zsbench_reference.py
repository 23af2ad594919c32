"""The plain reference on inputs at the edge of its arithmetic."""

import torch

from zsbench.reference import graph, recon, search, surface
from zsbench.runners import recon as recon_runner


def test_a_depth_map_that_is_zero_over_the_mask_stays_finite():
    seen = torch.zeros(2, 16, 3, requires_grad=True)
    out, mean, scale = graph.normalize_seen(seen * 1.0, torch.ones(2, 16))
    out.sum().backward()
    assert torch.isfinite(out).all() and torch.isfinite(seen.grad).all()
    assert torch.equal(scale, torch.full((2,), 1e-8))


def test_normalisation_centres_and_scales_the_visible_points():
    pts = torch.tensor([[[0.0, 0, 1], [2, 0, 1], [9, 9, 9]]])
    out, mean, scale = graph.normalize_seen(pts, torch.tensor([[1.0, 1.0, 0.0]]))
    assert torch.allclose(mean, torch.tensor([[1.0, 0, 1]])) and torch.allclose(scale, torch.tensor([1.0]))
    assert torch.allclose(out[0, 2], torch.zeros(3))  # off the mask


def level_grid(S=33, seed=0):
    """A bumpy sphere's occupancy on an ``S^3`` grid over [-1.5, 1.5]."""
    g = torch.Generator().manual_seed(seed)
    x = torch.linspace(-1.5, 1.5, S)
    p = torch.stack(torch.meshgrid(x, x, x, indexing="ij"), -1)
    return torch.sigmoid(-10 * (p.norm(dim=-1) - 0.8 + 0.05 * torch.randn(S, S, S, generator=g)))


def test_the_plain_sampler_draws_what_the_program_draws():
    """Same grid, same generator: the same points, densely and cell by cell
    (the program's sampler is the system under test, read here only as a
    second implementation of the protocol)."""
    from zeroshape_tpu_torch.metrics import eval3d
    from zeroshape_tpu_torch.ops import marching_cubes

    level = level_grid()
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    assert torch.equal(surface.sample_dense(level, gen(), 500), marching_cubes.sample_surface_points(level, gen(), 500))
    ids, valid, _ = eval3d._select_active_cells(level[::4, ::4, ::4], 0.45, 64)
    mine, _ = recon.select_cells(level[::4, ::4, ::4], 0.45, 64)
    assert torch.equal(surface.sample_cells(level, mine, gen(), 500, 4),
                       marching_cubes.sample_surface_points_cells(level, ids, valid, gen(), 500, factor=4))


def test_the_rotation_sphere_is_the_protocols():
    from zeroshape_tpu_torch.camera import get_rotation_sphere

    assert torch.equal(search.rotation_sphere(24, 24, 12, "cpu"), get_rotation_sphere(24, 24, 12, device="cpu"))


def test_the_search_finds_a_planted_rotation():
    level = level_grid(seed=1)
    pw = surface.sample_dense(level, torch.Generator().manual_seed(3), 400)
    pw = pw * torch.tensor([1.0, 0.6, 0.3])  # no symmetry to tie rotations
    rot = search.rotation_sphere(8, 8, 4, "cpu")
    gt = search.rotated(pw, rot[37:38])[0]
    cd, best = search.least_cd(pw, gt, rot, top=4)
    assert best == 37 and cd < 1e-5
    idx, cloud = search.closest_rotation(pw, gt, rot)
    assert idx == 37 and surface.far_share(cloud, gt, 1e-5) == 0.0


def test_a_grid_that_is_not_finite_or_saturated_wrongly_reads_as_a_wide_gap():
    s_r = torch.tensor([20.0, -100.0, 1.0, -1.0])
    occ = torch.sigmoid(s_r)
    assert recon_runner.logit_gap(occ, s_r, 1.0)[0] < 1e-5
    assert recon_runner.logit_gap(torch.where(torch.arange(4) == 2, torch.nan, occ), s_r, 1.0)[0] == float("inf")
    wrong = occ.clone()
    wrong[1] = 1.0  # saturated inside where the reference is far outside
    assert recon_runner.logit_gap(wrong, s_r, 1.0)[0] > 50
    assert recon_runner.logit_gap(torch.ones(4), s_r, 1.0)[0] == float("inf")  # nothing resolved


def test_a_nan_reads_as_the_worst_gap():
    from zsbench.runners import fold

    assert fold({"a": 0.1}, {"a": float("nan")}) == {"a": float("inf")}
    assert fold({"a": 0.1}, {"a": 0.05}) == {"a": 0.1}


def test_leaves_the_loss_no_longer_reaches_are_left_out():
    """A dead part of the network (most leaves with a zero gradient) neither
    divides by zero nor sets the median leaf."""
    from zsbench.runners.train import compare

    grads = {"dead0": 0.0, "dead1": 0.0, "dead2": 0.0, "w": 2.0, "v": 1.0}
    ref = ([1.0], grads, {"dead0": 1e-8, "dead1": 1e-8, "dead2": 1e-8, "w": 0.1, "v": 0.2})
    got = ([1.001], dict(grads, w=2.02), {"dead0": 1e-8, "dead1": 1e-8, "dead2": 1e-8, "w": 0.1, "v": 0.21})
    numbers, details = compare(ref, got)
    assert details["leaves"] == 2 and details["zero_grad_ref"] == 3
    assert abs(numbers["grad_gap_med"] - 0.01) < 1e-9 and abs(numbers["change_gap_med"] - 0.05) < 1e-9
    assert compare(ref, (got[0], got[1], dict(got[2], v=0.0)))[0]["change_gap"] == 1.0
