"""The check that decides ``correct``, at a size a test run holds.

A whole run on the CPU (the card check skipped) of each runner at narrow
widths and 32^2 images, held to the shipped cells' own limits: a sound run
comes out correct; with the timed path broken underneath (each fault the
cell can have, numbers that are not finite among them, and faults that
start only after the checked training steps) it comes out not correct; and
the control (the reference under fp8 matmuls in the program's place) fails
at least one number. On the card, ``test_control_fails_at_the_cells_size``
reads the control at each cell's own size.
"""

import json
import shutil
import types

import pytest
import torch

from zsbench import calibrate, manifest, program, run
from zsbench.tests import tiny

CELLS = {"zeroshape.recon_b8": (False, "recon"), "zeroshape_vit.train_b28": (True, "train"),
         "zeroshape.eval_final": (False, "score")}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zsbench_root")
    cells = {f"t.{name}": spec for name, spec in CELLS.items()}
    tiny.make_root(tmp, cells)
    for name in CELLS:  # the shipped cells' limits
        shutil.copy(manifest.HERE / "limits" / f"{name}.json", tmp / "limits" / f"t.{name}.json")
    return tmp


def one_run(root, cell, trace=0):
    args = types.SimpleNamespace(workload=f"t.{cell}", seed=2**31 + 5, seconds=0.5, trace=trace)
    return run.run(args, root=root, here=root, skip_card_check=True)


@pytest.mark.parametrize("cell", list(CELLS))
def test_a_sound_run_is_correct(root, cell):
    res = one_run(root, cell)
    assert res["correct"], res["compared"]
    assert list(res)[-1] == "compared"
    assert set(res) >= {"correct", "attempted", "failed", "metrics", "device"}


def on_recon_outputs(change):
    """``reconstruct_batch`` with ``change(out, level, world)`` applied to what it returns."""
    def wrap(fn):
        def broken(*a, **kw):
            out, level, world, n_active = fn(*a, **kw)
            out, level, world = change(dict(out), level.clone(), world.clone())
            return out, level, world, n_active
        return broken
    return wrap


def swap_grids(out, level, world):
    return out, level.flip(0), world  # the grids of the batch's samples exchanged


def nan_depth(out, level, world):
    out["depth_pred"] = out["depth_pred"].clone()
    out["depth_pred"][0, :4] = float("nan")  # a few rows of one sample's depth map
    return out, level, world


def nan_in_grid(out, level, world):
    level[0, :2] = float("nan")  # two planes of one sample's grid
    return out, level, world


def saturated_slab(out, level, world):
    level[0, :2] = 1.0  # two planes of one sample's grid written as certainly inside
    return out, level, world


def moved_samples(out, level, world):
    return out, level, world + torch.tensor([3.0 / 16, 0.0, 0.0])  # one voxel of the tiny grid along x


def leave_state_unchanged(fn, after=0):
    calls = [0]

    def broken(model, optimizer, batch, opt, **kw):
        calls[0] += 1
        if calls[0] <= after:
            return fn(model, optimizer, batch, opt, **kw)
        step, optimizer.step = optimizer.step, lambda: False
        try:
            return fn(model, optimizer, batch, opt, **kw)
        finally:
            optimizer.step = step
    return broken


def half_the_batch(fn, after=0):
    calls = [0]

    def broken(model, optimizer, batch, opt, dp_masks=None, **kw):
        calls[0] += 1
        if calls[0] <= after:
            return fn(model, optimizer, batch, opt, dp_masks=dp_masks, **kw)
        n = batch["rgb_input_map"].shape[0] // 2
        masks = {k: [tuple(x[:n] for x in m) if isinstance(m, tuple) else m[:n] for m in ms]
                 for k, ms in dp_masks.items()}
        return fn(model, optimizer, {k: v[:n] for k, v in batch.items()}, opt, dp_masks=masks, **kw)
    return broken


def on_scores(change):
    def wrap(fn):
        def broken(*a, **kw):
            acc, comp, f, n_active, drawn = fn(*a, **kw)
            acc, comp, f, drawn = change(acc.copy(), comp.copy(), f.copy(), dict(drawn))
            return acc, comp, f, n_active, drawn
        return broken
    return wrap


def swap_scores(acc, comp, f, drawn):
    return acc[::-1].copy(), comp[::-1].copy(), f[::-1].copy(), drawn


def nan_cd(acc, comp, f, drawn):
    acc[0] = float("nan")
    return acc, comp, f, drawn


CHECKED = tiny.MIXES["train"]["check_steps"]
PATH_FAULTS = {
    "recon-answer-altered": ("zeroshape.recon_b8", "reconstruct_batch", on_recon_outputs(swap_grids)),
    "recon-nan-depth": ("zeroshape.recon_b8", "reconstruct_batch", on_recon_outputs(nan_depth)),
    "recon-nan-in-grid": ("zeroshape.recon_b8", "reconstruct_batch", on_recon_outputs(nan_in_grid)),
    "recon-saturated-slab": ("zeroshape.recon_b8", "reconstruct_batch", on_recon_outputs(saturated_slab)),
    "recon-samples-moved": ("zeroshape.recon_b8", "reconstruct_batch", on_recon_outputs(moved_samples)),
    "train-state-unchanged": ("zeroshape_vit.train_b28", "train_step", leave_state_unchanged),
    "train-half-batch": ("zeroshape_vit.train_b28", "train_step", half_the_batch),
    "train-state-unchanged-in-window": ("zeroshape_vit.train_b28", "train_step",
                                        lambda fn: leave_state_unchanged(fn, after=CHECKED)),
    "train-half-batch-in-window": ("zeroshape_vit.train_b28", "train_step",
                                   lambda fn: half_the_batch(fn, after=CHECKED)),
    "score-answer-altered": ("zeroshape.eval_final", "score_batch", on_scores(swap_scores)),
    "score-nan-cd": ("zeroshape.eval_final", "score_batch", on_scores(nan_cd)),
}


@pytest.mark.parametrize("case", list(PATH_FAULTS))
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, case):
    cell, entry, fault = PATH_FAULTS[case]
    monkeypatch.setattr(program, entry, fault(getattr(program, entry)))
    res = one_run(root, cell)
    assert not res["correct"], res["compared"]


def test_a_search_over_half_the_rotations_is_not_correct(root):
    with calibrate.half_rotations():
        res = one_run(root, "zeroshape.eval_final")
    assert not res["correct"], res["compared"]
    assert res["compared"]["search_gap"]["value"] > res["compared"]["search_gap"]["limit"]


@pytest.mark.parametrize("cell", list(CELLS))
def test_the_control_fails_a_number(root, cell):
    _, summary = calibrate.readings(f"t.{cell}", [], [7], [], root=root, here=root)
    limits = manifest.limits(cell)
    control = summary["control min"]
    assert any(control[k] > limits[k] for k in limits if k in control), (control, limits)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in manifest.load()["workloads"]])
def test_control_fails_at_the_cells_size(card, cell):
    """Three seeds of the control at the cell's own size (minutes a cell)."""
    _, summary = calibrate.readings(cell, [], [11, 12, 13], [])
    limits = manifest.limits(cell)
    worst_control = {k: v for k, v in summary["control min"].items() if k in limits}
    assert any(v > limits[k] for k, v in worst_control.items()), json.dumps(worst_control)
