"""The reconstruction stage timers (``zeroshape_tpu_torch.time_recon``) on the
CPU at tiny size: every subcommand end to end with the keys of its JSON
line; ``k1_builds`` needs the card, and its pieces are checked here."""

import json
import os

import numpy as np
import pytest
import torch

from zeroshape_tpu_torch import recon, time_recon
from zeroshape_tpu_torch.metrics import eval3d
from zeroshape_tpu_torch.ops import _build
from zeroshape_tpu_torch.ops import implicit_kernel as ik

from test_torch_harness import few_threads, give_memory_back  # noqa: F401 (autouse)

TINY = ["--device=cpu", "--H=32", "--W=32", "--arch.latent_dim=64", "--arch.impl.n_channels=64",
        "--arch.impl.mlp_layers=4", "--arch.impl.skip_in=[2]", "--arch.depth.n_blocks=2", "--vox_res=16", "--reps=1"]


SETUPS = {}


def _last_json(capsys):
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["tool"] == "time_recon" and rec["card"] == "cpu"
    return rec


@pytest.mark.parametrize("sub,keys", [
    ("components", ("encode_image_ms", "encode_latents_ms", "dense_decode_ms", "dense_sample_ms", "k1_launches")),
    ("decode", ("dense_k1_ms", "hier_k1_ms", "hier_sign_agree", "dense_plain_ms", "hier_plain_ms",
                "hier_k1_plain_sign_agree", "tiles")),
    ("hier_parts", ("select_ms", "gather_ms", "upsample_nearest_ms", "scatter_ms", "sigmoid_ms", "n_active")),
    ("sampling", ("launch_floor_ms", "triangle_areas_slab4_ms", "triangle_areas_slab32_ms", "cumsum_ms",
                  "draw_slots_ms", "sample_from_tris_ms", "sample_surface_points_ms",
                  "sample_surface_points_cells_ms")),
])
def test_subcommand_runs_and_reports(sub, keys, capsys, monkeypatch):
    setup = time_recon._setup
    # one tiny model for components and decode: its build and calibration are most of their time
    monkeypatch.setattr(time_recon, "_setup", lambda *a: SETUPS.get("tiny") or SETUPS.setdefault("tiny", setup(*a)))
    time_recon.main([sub, *TINY])
    rec = _last_json(capsys)
    assert rec["sub"] == sub and rec["vox_res"] == 16 and set(keys) <= set(rec)
    assert all(np.isfinite(rec[k]) for k in keys if k != "tiles")
    if sub == "decode":
        # K1 and the plain decode are one decode on the CPU: the grids agree
        assert rec["hier_k1_plain_sign_agree"] == 1.0 and rec["hier_sign_agree"] > 0.99
        assert [t["tile"] for t in rec["tiles"]] == time_recon.tile_sizes(16)
    if sub == "components":
        assert rec["k1_launches"] == 0 and rec["points"] == 17**3  # no kernel on the CPU


def test_hier_parts_pieces_rebuild_the_hierarchical_decode():
    """The stages ``hier_parts`` times compose to ``occupancy_grid_hierarchical``."""
    vox, factor = 16, 4
    field = lambda p: 4.0 * (0.8 - p.norm(dim=-1))  # a sphere's logits
    level, n_active, ids, valid = eval3d.occupancy_grid_hierarchical(
        field, vox, batch_size=1, factor=factor, capacity=40, return_stats=True, return_cells=True, device="cpu")
    nc = vox // factor
    occ_c = torch.sigmoid(field(eval3d.coarse_lattice(vox, device="cpu"))).reshape(1, nc + 1, nc + 1, nc + 1)
    sel = eval3d._select_active_cells(occ_c[0], recon.MARGIN, 40)
    assert torch.equal(sel[0], ids[0]) and torch.equal(sel[1], valid[0]) and int(sel[2]) == int(n_active[0])
    pts, fidx = eval3d._fine_points(ids, torch.linspace(-1.5, 1.5, vox + 1), nc, factor)
    assert torch.equal(eval3d._scatter_fine(occ_c, fidx, valid, torch.sigmoid(field(pts)), factor), level)


def test_k1_builds_needs_the_card():
    with pytest.raises(RuntimeError, match="needs the card"):
        time_recon.k1_builds([os.path.join(_build.CSRC, ik._SOURCE)], device="cpu")


def test_the_shipped_source_reuses_the_main_build():
    shipped = os.path.join(_build.CSRC, ik._SOURCE)
    names = time_recon.library_names([shipped, "local/old_implicit_decoder.cu", os.path.relpath(shipped)])
    assert names == [ik._NAME, "zs_k1_cmp1", ik._NAME]


def test_k1_agreement_holds_the_bf16_bounds():
    rng = np.random.default_rng(0)
    ref = torch.tensor(rng.normal(size=4096) * 3)
    ok, dmax, dmean, corr = time_recon.k1_agreement(ref + 1e-3, ref)
    assert ok and abs(dmax - 1e-3) < 1e-9 and corr > 0.9999
    assert not time_recon.k1_agreement(ref + 0.1, ref)[0]  # past atol + rtol on small logits
    assert not time_recon.k1_agreement(torch.where(ref > 0, float("nan"), ref), ref)[0]
