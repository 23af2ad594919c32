"""The training-time tools (``zeroshape_tpu_torch.time_train``) on the CPU at
tiny size: the bisection median against the sort median and the JAX
``_masked_median``, and every subcommand end to end with the keys of its
JSON line."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshape_tpu import losses as jlosses
from zeroshape_tpu_torch import generalize_e2e, losses, profile_train, time_train

from test_torch_harness import few_threads, give_memory_back  # noqa: F401 (autouse)

TINY = ["--device=cpu", "--H=32", "--W=32", "--training.n_sdf_points=64"]


def _rows(case):
    """Rows of fp32 values and masks that exercise the selection's edge cases."""
    rng = np.random.default_rng(3)
    if case == "random":
        x = rng.normal(size=(4, 257)).astype(np.float32)
        m = rng.uniform(size=x.shape) < 0.6
    elif case == "ties":  # few distinct values, the median tied many times over
        x = rng.integers(-3, 4, size=(4, 100)).astype(np.float32) / 2
        m = rng.uniform(size=x.shape) < 0.8
    elif case == "empty":  # no masked element in some rows
        x = rng.normal(size=(3, 16)).astype(np.float32)
        m = np.zeros(x.shape, bool)
        m[1, ::3] = True
    elif case == "signed_zeros":  # -0.0 sorts below +0.0 in the order keys
        x = np.array([[0.0, -0.0, 0.0, -0.0, 1.0], [-0.0, -0.0, 0.0, -1.0, 0.0]], np.float32)
        m = np.ones(x.shape, bool)
    else:  # one element, and the extremes of the float range
        x = np.array([[3.0, 0, 0], [np.finfo(np.float32).max, -np.finfo(np.float32).max, 1e-30]], np.float32)
        m = np.array([[True, False, False], [True, True, True]])
    return x, m


@pytest.mark.parametrize("case", ["random", "ties", "empty", "signed_zeros", "extremes"])
def test_bisection_median_is_the_sort_median_and_the_jax_median(case):
    x, m = _rows(case)
    got = {}
    for name, fn in (("bisection", time_train.bisection_median), ("sort", losses._masked_median)):
        t = torch.tensor(x, requires_grad=True)
        med = fn(t, torch.tensor(m))
        (med * torch.arange(1.0, len(x) + 1)).sum().backward()
        got[name] = (med.detach().numpy(), t.grad.numpy())
    want = np.asarray(jlosses._masked_median(jnp.asarray(x), jnp.asarray(m)))
    for name in ("bisection", "sort"):
        assert got[name][0].tobytes() == want.tobytes(), (name, got[name][0], want)  # bit for bit, -0.0 included
    np.testing.assert_array_equal(got["bisection"][1], got["sort"][1])


def _last_json(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    assert rec["card"] == "cpu"
    return rec


def test_batch_windows_and_parts_run_and_report(capsys, monkeypatch):
    built = {}
    build = profile_train.build
    # one tiny depth graph for the three runs: its build is most of their time
    monkeypatch.setattr(profile_train, "build", lambda *a: built.get(a[1]) or built.setdefault(a[1], build(*a)))
    time_train.main(["batch", "2", "--task=depth", "--reps=1", "--warmup=1", *TINY])
    rec = _last_json(capsys)
    assert rec["tool"] == "time_train" and rec["sub"] == "batch"
    (row,) = rec["rows"]
    assert {"task", "batch", "ms_pipelined", "ms_synced", "img_s", "peak_gib"} <= set(row) and row["batch"] == 2
    time_train.main(["windows", "--windows=2", "--K=1", "--batch_size=2", "--task=depth", *TINY])
    rec = _last_json(capsys)
    assert [r["window"] for r in rec["rows"]] == [0, 1] and all(r["ms_synced"] > 0 for r in rec["rows"])
    time_train.main(["parts", "--batch_size=2", "--reps=1", "--K=1", "--task=depth", *TINY])
    rec = _last_json(capsys)
    keys = ("fwd_loss_ms", "fwd_bwd_ms", "step_ms", "sync_every_step_ms", "sync_once_ms", "step_interpolate_ms",
            "step_separable_ms")
    assert all(rec[k] > 0 for k in keys)


def test_the_separable_resize_is_the_dpt_resize():
    """The A/B's second arm computes the same resize (within fp32 rounding),
    and the patch is undone after its block."""
    from zeroshape_tpu_torch.models import dpt
    from zeroshape_tpu_torch.ops.image import resize_bilinear, upsample2x

    x = torch.randn(2, 3, 7, 5)
    with time_train.separable_resize():
        sep_up, sep = dpt.upsample2x(x), dpt.resize_bilinear(x, (9, 4))
    torch.testing.assert_close(sep_up, upsample2x(x), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(sep, resize_bilinear(x, (9, 4)), rtol=1e-6, atol=1e-6)
    assert dpt.upsample2x is upsample2x and dpt.resize_bilinear is resize_bilinear


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree")
    generalize_e2e.main(["gen", str(root), "--H=32", "--n_objects=2", "--holdout_objects=1", "--n_pc_points=200",
                         "--n_sdf_points=500"])
    return str(root)


def test_loader_and_midas_run_and_report(tree, capsys):
    time_train.main(["loader", f"--data.root={tree}", "--batch_size=2", "--epochs=1", "--workers=2", "--step_ms=2",
                     *TINY])
    rec = _last_json(capsys)
    assert rec["samples"] == 14 and rec["img_s"] > 0 and rec["decode_numpy_png_img_s"] > 0
    assert {"decode_zsdl_img_s", "gap_median_ms", "gap_p95_ms", "step_ms", "step_img_s"} <= set(rec)
    time_train.main(["midas", "2", "--reps=1", "--H=32", "--device=cpu"])
    (row,) = _last_json(capsys)["rows"]
    assert row["equal"] and row["sort_ms"] > 0 and row["bisection_ms"] > 0 and np.isfinite(row["value"])


def test_depth_probe_runs_and_counts(tree, capsys):
    time_train.main(["depth", f"--data.root={tree}", "--repeats=2", "--steps=3", "--batch_size=2", *TINY[:3]])
    out = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(out[-1])
    assert sum(x.startswith("run 1 step ") for x in out) == 3
    assert rec["sub"] == "depth" and rec["repeats"] == 2 and rec["steps"] == 3 and rec["dead"] == 0
    assert rec["identical"]  # the CPU's runs repeat bit for bit
    assert {"dead", "loss_depth_last", "bias_last", "bias_min", "dead_share_last", "clamp_share_last",
            "grad_norm_last"} <= set(rec["runs"][0])


def test_dead_rule():
    run = {"dead_share": np.full(60, 0.995), "clamp_share": np.zeros(60), "loss_depth": np.full(60, 1.004),
           "grad_norm": np.full(60, 50.0)}
    assert time_train.is_dead(run)
    assert not time_train.is_dead(dict(run, loss_depth=np.r_[np.full(59, 1.004), 0.9]))
    assert not time_train.is_dead(dict(run, dead_share=np.r_[np.full(59, 1.0), 0.98]))
    assert time_train.is_dead(dict(run, dead_share=np.r_[np.zeros(10), np.full(50, 1.0)]))  # the last 50 count
    # a head saturated at the clamp's top is as dead as one below its ReLU
    assert time_train.is_dead(dict(run, dead_share=np.zeros(60), clamp_share=np.full(60, 1.0)))
    assert time_train.is_dead(dict(run, dead_share=np.full(60, 0.5), clamp_share=np.full(60, 0.495)))
    # a map flattened onto the head's bias: every pixel alive, no gradient
    flat = dict(run, dead_share=np.zeros(60), grad_norm=np.full(60, 4e-5))
    assert time_train.is_dead(flat)
    assert not time_train.is_dead(dict(flat, grad_norm=np.r_[np.full(59, 4e-5), 0.1]))
