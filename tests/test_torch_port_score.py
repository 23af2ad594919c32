"""PyTorch port vs the JAX package: scoring and evaluation.

The rotation sphere, normalisation, F-score, GT view transform, ICP, the
brute-force alignment (pruned and exhaustive), the dense surface sampler,
the analytic scene copy and the evaluator. Inputs are made with numpy from
a seed and given to both packages.

Tolerances: rotations, normalisation, F-score and view transform 1e-6; ICP
(10 iterations) 1e-4; brute force: the same rotation and acc/comp 1e-5; the
dense sampler with injected uniforms 1e-5; the analytic copy exact; the
evaluator's per-sample metrics 1e-5 against JAX's scoring of the same
predicted clouds.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshape_tpu import camera as jcam
from zeroshape_tpu.data import analytic as jan
from zeroshape_tpu.data.common import pose_from_Rt as j_pose_from_Rt
from zeroshape_tpu.metrics import eval3d as je
from zeroshape_tpu.ops import marching_cubes as jmc
from zeroshape_tpu.runtime.shape_engine import Runner
from zeroshape_tpu_torch import camera, config, recon
from zeroshape_tpu_torch.data import analytic
from zeroshape_tpu_torch.data.base import default_collate
from zeroshape_tpu_torch.metrics import eval3d as te
from zeroshape_tpu_torch.ops import marching_cubes as tmc
from zeroshape_tpu_torch.runtime import shape_engine

from test_torch_harness import close, np32, t
from test_torch_harness import few_threads, give_memory_back  # noqa: F401 (autouse: two threads; memory back at the end)

ROT = (6, 6, 4)  # 144 rotations


@pytest.mark.parametrize("samples,scales", [((24, 24, 12), 1.0), (ROT, (1.0, 0.5))])
def test_rotation_sphere(samples, scales):
    got = camera.get_rotation_sphere(*samples, scales=scales, device="cpu")
    want = jcam.get_rotation_sphere(*samples, scales=scales)
    assert got.shape == want.shape
    close(got, want, 1e-6)


def test_normalize_fscore_and_view_transform():
    rng = np.random.default_rng(0)
    pc = rng.normal(size=(3, 400, 3)).astype(np.float32) * [0.3, 0.5, 0.2] + 0.1
    close(te.normalize_pc(t(pc)), je.normalize_pc(jnp.asarray(pc)), 1e-6)
    d1, d2 = rng.uniform(0, 0.15, (3, 400)).astype(np.float32), rng.uniform(0, 0.15, (3, 300)).astype(np.float32)
    d1[0] = 1.0  # precision and recall both 0 at every threshold: F = 0
    d2[0] = 1.0
    close(te.compute_fscore(t(d1), t(d2)), je.compute_fscore(jnp.asarray(d1), jnp.asarray(d2)), 1e-6)
    assert te.DEFAULT_F_THRESHOLDS == je.DEFAULT_F_THRESHOLDS
    pose = np.concatenate([rng.normal(size=(3, 3, 3)), rng.normal(size=(3, 3, 1))], axis=2).astype(np.float32)
    for flip in (False, True):
        close(te.transform_gt_to_view(t(pc), t(pose), flip), je.transform_gt_to_view(jnp.asarray(pc), jnp.asarray(pose), flip), 1e-6)
    assert torch.equal(te.normalize_pc(torch.zeros(1, 5, 3)), torch.zeros(1, 5, 3))  # an empty surface


def test_icp():
    rng = np.random.default_rng(1)
    X2 = rng.normal(size=(2, 300, 3)).astype(np.float32) * [0.5, 0.3, 0.2]
    a = np.deg2rad(20.0)
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)
    X1 = (X2 @ R.T + 0.05 + rng.normal(0, 0.01, X2.shape)).astype(np.float32)[:, :250]
    got = te.icp(t(X1), t(X2), num_iter=10)
    want = je.icp(jnp.asarray(X1), jnp.asarray(X2), num_iter=10, use_pallas=False)
    close(got, want, 1e-4)
    assert float(te.chamfer_eval(got, t(X2))[0].mean()) < float(te.chamfer_eval(t(X1), t(X2))[0].mean())


def test_icp_rotation_is_invariant_to_svd_sign_flips():
    """``R = V U^T`` does not change when a singular pair (u_i, v_i) flips sign."""
    H = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 3)).astype(np.float64))
    U, _, Vt = torch.linalg.svd(H)
    flip = torch.diag(torch.tensor([1.0, -1.0, -1.0], dtype=torch.float64))
    R = Vt.T @ U.T
    assert torch.allclose((Vt.T @ flip) @ (U @ flip).T, R, atol=1e-12)


@pytest.fixture(scope="module")
def clouds():
    """A jittered box's GT cloud (512 points) and an independent 384-point
    draw of the same surface, rotated: a search with one clear winner."""
    rng = np.random.default_rng(3)
    sdf, _ = analytic.make_sdf("box", rng)
    gt = analytic.surface_points(sdf, 512, rng)
    pred = analytic.surface_points(sdf, 384, rng)
    R = np.asarray(jcam.get_rotation_sphere(*ROT))[77]
    return (pred @ R).astype(np.float32), gt  # R^T applied to every point


@pytest.mark.parametrize("prune,fast", [(None, True), ((1024, 128), True), ((1024, 128), False), ((128, 16), True)])
def test_brute_force_search(clouds, prune, fast):
    pred, gt = clouds
    kw = dict(rot_samples=ROT, prune=prune, fast_coarse=fast)
    got = te.brute_force_search(t(pred), t(gt), **kw)
    want = je.brute_force_search(jnp.asarray(pred), jnp.asarray(gt), use_pallas=False, **kw)
    close(got["rotation"], want["rotation"], 1e-6)
    for k in ("acc", "comp", "f_score", "pc_gt"):
        close(got[k], want[k], 1e-5, k)
    close(got["pc_pred"], want["pc_pred"], 1e-5)
    batched = te.brute_force_batch(t(np.stack([pred, pred])), t(np.stack([gt, gt])), **kw)
    assert batched["acc"].shape == (2,) and torch.equal(batched["rotation"][1], got["rotation"])


def test_dense_sampler_matches_jax_with_injected_uniforms():
    g = np.linspace(-1.5, 1.5, 25)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    level = (1 / (1 + np.exp(-8 * (0.9 - np.sqrt(X**2 + 2 * Y**2 + (Z - 0.2) ** 2))))).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jmc.sample_surface_points(jnp.asarray(level), key, 1500)
    k1, k2 = jax.random.split(key)  # the draws the JAX sampler makes from its key
    u, r = np32(jax.random.uniform(k1, (1500,))), np32(jax.random.uniform(k2, (1500, 2)))
    got = tmc.sample_surface_points(t(level), num_points=1500, u_slots=t(u), r_bary=t(r))
    close(got, want, 1e-5)
    # slabs bound memory only: the areas do not depend on the slab size
    assert torch.equal(tmc.triangle_areas(t(level), slab=8), tmc.triangle_areas(t(level), slab=5))
    empty = tmc.sample_surface_points(torch.zeros(9, 9, 9), torch.Generator().manual_seed(0), 10)
    assert torch.equal(empty, torch.zeros(10, 3))


@pytest.mark.parametrize("kind", analytic.SDF_KINDS)
def test_analytic_copy_is_exact(kind):
    sdf, albedo = analytic.make_sdf(kind, np.random.default_rng(6))
    jsdf, jalbedo = jan.make_sdf(kind, np.random.default_rng(6))
    p = np.random.default_rng(7).uniform(-0.7, 0.7, (500, 3))
    np.testing.assert_array_equal(sdf(p), jsdf(p))
    np.testing.assert_array_equal(albedo, jalbedo)
    np.testing.assert_array_equal(analytic.surface_points(sdf, 200, np.random.default_rng(8)),
                                  jan.surface_points(jsdf, 200, np.random.default_rng(8)))
    np.testing.assert_array_equal(analytic.sdf_samples(sdf, 100, np.random.default_rng(8))[1],
                                  jan.sdf_samples(jsdf, 100, np.random.default_rng(8))[1])
    cams = analytic._camera_ring(3, np.random.default_rng(9))
    np.testing.assert_array_equal(np.stack(cams), np.stack(jan._camera_ring(3, np.random.default_rng(9))))
    pose = analytic.look_at_pose(cams[1])
    np.testing.assert_array_equal(pose, jan.look_at_pose(cams[1]))
    np.testing.assert_array_equal(analytic.pose_from_Rt(pose), j_pose_from_Rt(pose))
    K = np.array([[33.3, 0, 12], [0, 33.3, 12], [0, 0, 1]], np.float32)
    for a, b in zip(analytic.render_scene(sdf, albedo, K, pose, 24, 24), jan.render_scene(jsdf, jalbedo, K, pose, 24, 24)):
        np.testing.assert_array_equal(a, b)


def test_eval_samples_match_the_written_dataset(tmp_path):
    """``eval_samples`` gives what ``generate_dataset`` + ``SyntheticDataset``
    load for the test split."""
    from zeroshape_tpu.config import Config
    from zeroshape_tpu.data.synthetic import SyntheticDataset

    kw = dict(n_objects=3, n_views=2, H=32, seed=4, n_pc_points=128, n_sdf_points=64)
    jan.generate_dataset(str(tmp_path), val_views=1, **kw)
    opt = Config({"H": 32, "W": 32, "seed": 0, "training": {"n_sdf_points": 16},
                  "data": {"root": str(tmp_path), "synthetic": {"subset": "analytic", "percentage": 1}}})
    ds = SyntheticDataset(opt, split="test")
    got = analytic.eval_samples(**kw)
    assert len(got) == len(ds) == 3 and ds.label2cat == ["prim"]
    for i, s in enumerate(got):
        want = ds[i]
        for k in ("idx", "category_label", "pose_gt", "rgb_input_map", "mask_input_map"):
            np.testing.assert_array_equal(s[k], want[k], err_msg=k)
            assert np.asarray(s[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(s["dpc"]["points"], want["dpc"]["points"])


@pytest.fixture(scope="module")
def evaluator_setup():
    """A tiny model on the CPU, its random field calibrated to hold a surface,
    and two analytic test samples."""
    samples = analytic.eval_samples(n_objects=2, n_views=2, H=32, seed=0, n_pc_points=256, n_sdf_points=256)
    model = recon.build(config.tiny_opt(32), device="cpu", seed=0)
    batch = {k: samples[0][k][None] for k in ("rgb_input_map", "mask_input_map")}
    recon.calibrate_random_field(model, batch, target=20, vox_res=16)
    return model, samples


def _jax_score(pred, gt_view, use_icp, thresholds):
    """``shape_engine.py:334-341`` on the JAX side."""
    pred_n, gt_n = je.normalize_pc(jnp.asarray(pred)), je.normalize_pc(jnp.asarray(gt_view))
    if use_icp:
        pred_n = je.icp(pred_n, gt_n, use_pallas=False)
    acc, comp = je.chamfer_eval(pred_n, gt_n, use_pallas=False)
    return acc.mean(axis=1), comp.mean(axis=1), je.compute_fscore(acc, comp, thresholds)


@pytest.mark.parametrize(
    "vox,training,extra",
    [(16, False, {}), (32, True, {}), (16, False, {"icp": True}), (16, False, {"brute_force": True})],
)
def test_evaluate_matches_jax_scoring(evaluator_setup, tmp_path, vox, training, extra):
    model, samples = evaluator_setup
    opt = config.eval_opt(config.tiny_opt(32), vox_res=vox, num_points=256, **extra)
    thresholds = tuple(opt.eval.f_thresholds)
    res = shape_engine.evaluate(model, samples, opt, str(tmp_path), ["prim"], training=training, device="cpu")

    # the same predicted clouds: the same posture and a generator a sample, keyed on its index
    hier = shape_engine.use_hier_decode(opt, training)
    assert hier == (vox == 32 and training)
    bs = opt.eval.batch_size
    for b, batch in enumerate(default_collate(samples[i: i + bs]) for i in range(0, len(samples), bs)):
        gens = shape_engine.sample_generators(batch["idx"], "cpu")
        _, _, pred, n_active = recon.reconstruct_batch(model, batch, gens, vox, None, 256, (-1.5, 1.5), hier)
        assert (n_active is None) == (not hier)
        gt_view = je.transform_gt_to_view(jnp.asarray(batch["dpc"]["points"]), jnp.asarray(batch["pose_gt"]))
        sl = slice(2 * b, 2 * b + len(pred))
        if extra.get("brute_force"):
            for i in range(len(pred)):
                w = je.brute_force_search(jnp.asarray(pred[i].numpy()), gt_view[i], thresholds, use_pallas=False, prune=None)
                close(res["acc"][sl][i], w["acc"], 1e-5)
                close(res["comp"][sl][i], w["comp"], 1e-5)
                close(res["f_score"][sl][i], w["f_score"], 1e-5)
        else:
            acc, comp, f = _jax_score(pred.numpy(), gt_view, extra.get("icp", False), thresholds)
            close(res["acc"][sl], acc, 1e-5)
            close(res["comp"][sl], comp, 1e-5)
            close(res["f_score"][sl], f, 1e-5)
    assert np.isfinite(res["val_metric"]) and len(res["s_per_sample"]) == 1

    files = sorted(os.listdir(tmp_path))
    if training:  # validation writes no result files (shape_engine.py:605, 711)
        assert files == []
        return
    # with the dumps of every sample (shape_engine.py:715-741) and the gallery (:772-776)
    assert files == ["cd_cat.txt", "dump_synthetic", "quantitative_synthetic.txt", "results_test.html",
                     "synthetic_full_results.txt"]
    assert sorted({int(f.split("_")[0]) for f in os.listdir(tmp_path / "dump_synthetic")}) == list(range(len(samples)))
    rows = (tmp_path / "synthetic_full_results.txt").read_text().split("\n")
    assert rows[0] == "IND, CD, ACC, COMP, F-score@0.50, F-score@1.00, F-score@2.00, F-score@5.00, F-score@10.00, F-score@20.00"
    for i, row in enumerate(rows[1:]):
        cols = row.split("\t")
        assert int(cols[0]) == i and len(cols) == 4 + len(thresholds)
        assert cols[1:4] == [f"{x:.4f}" for x in ((res["acc"][i] + res["comp"][i]) / 2, res["acc"][i], res["comp"][i])]
    # the summaries, byte for byte against the JAX engine's writer on the same rows
    ref = tmp_path / "ref"
    ref.mkdir()
    fake = types.SimpleNamespace(opt=types.SimpleNamespace(output_path=str(ref), data=opt.data, eval=opt.eval),
                                 test_data=types.SimpleNamespace(label2cat=["prim"]))
    Runner._write_summaries(fake, res["acc"], res["comp"], res["f_score"], res["category_label"],
                            (res["acc"].mean() + res["comp"].mean()) / 2)
    for name in ("cd_cat.txt", "quantitative_synthetic.txt"):
        assert (tmp_path / name).read_bytes() == (ref / name).read_bytes(), name


def test_final_metrics_refuse_an_overflowing_hier_decode(evaluator_setup, tmp_path):
    model, samples = evaluator_setup
    opt = config.eval_opt(config.tiny_opt(32), vox_res=32, num_points=64, hier_final=True, hier_capacity=1)
    with pytest.raises(RuntimeError, match="exceed eval.hier_capacity"):
        shape_engine.evaluate(model, samples, opt, str(tmp_path), ["prim"], training=False, device="cpu")
    assert shape_engine.check_hier_overflow(torch.tensor([5]), opt, True, False) is True
    assert shape_engine.check_hier_overflow(torch.tensor([1]), opt, False, False) is False
