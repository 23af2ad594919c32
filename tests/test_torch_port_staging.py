"""Depth pretraining and its staging into shape training, on the CPU:

* a tiny ``python -m zeroshape_tpu_torch.train --task=depth`` run writes
  ``best.ckpt`` and ``latest.ckpt`` (the reference depth graph's layout,
  read by the JAX importer with nothing missing) and, through the final
  evaluation, ``best_val.txt`` in the JAX engine's format;
* the JAX ``stage_pretrained`` and the port's stage that file into a shape
  graph with the same weights (compared through ``weights.from_flax``);
* an omnidata-layout file stages into a depth graph; a set but absent path,
  a directory, a missing key and a wrong-shaped tensor raise;
* ``--load`` restores the weights and not the optimizer;
* the presets follow ``options/depth_gen.yaml`` and the accuracy gate's
  options; the CLI picks the engine by the JAX rule;
* the decode is chosen by the decoder's shapes (``kernel_supported``, held
  to the JAX ``fused_supported`` in ``test_torch_port_implicit.py``): a
  narrow decoder packs nothing and decodes plainly.

The encoders keep their full width at the tiny size, so a depth checkpoint
(DPT, intrinsics head, AdamW state) holds about 1.7 GB; the run's directory
is removed when the tests are done.
"""

import copy
import os
import re
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from zeroshape_tpu.config import load_options
from zeroshape_tpu.models.graph_shape import ShapeGraph as JShapeGraph
from zeroshape_tpu.parallel.train import TrainState
from zeroshape_tpu.runtime import checkpoint as jckpt
from zeroshape_tpu_torch import config, recon, weights
from zeroshape_tpu_torch.metrics.depth_metrics import metric_keys
from zeroshape_tpu_torch.models.graph_depth import DepthGraph
from zeroshape_tpu_torch.models.graph_shape import ShapeGraph
from zeroshape_tpu_torch.models.implicit import Implicit
from zeroshape_tpu_torch.parallel import train as ptrain
from zeroshape_tpu_torch.runtime import checkpoint, depth_engine, engine_base
from zeroshape_tpu_torch.train import main as train_main
from zeroshape_tpu_torch.train import options as train_options

from test_torch_harness import few_threads, give_memory_back  # noqa: F401 (autouse: two threads; memory back at the end)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = 32
DEPTH = [f"--image_size=[{H},{H}]", "--batch_size=2", "--max_epoch=1", "--seed=3", "--tb=null", "--freq.print=1",
         "--freq.scalar=1", "--freq.ckpt_latest=1000", "--freq.eval=1", "--eval.batch_size=2", "--device=cpu"]
DEPTH_SUBTREES = ("dpt_depth.", "intr_head.", "intr_proj.")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One epoch of one depth step (2 objects x 1 training view, batch 2)
    through the CLI on an analytic tree the port writes, validated before and
    after, then the final metrics (``best_val.txt``)."""
    from zeroshape_tpu_torch.data import analytic

    root = tmp_path_factory.mktemp("tree")
    analytic.generate_dataset(str(root), n_objects=2, n_views=2, H=H, seed=0, n_pc_points=300, n_sdf_points=400)
    out = tmp_path_factory.mktemp("depth")
    try:
        res = train_main(["--task=depth"] + DEPTH + [f"--data.root={root}", f"--output_path={out}"])
        os.remove(out / "checkpoint" / "ep0.ckpt")  # ~1.7 GB that no test reads
        opt = train_options(["--task=depth"] + DEPTH)
        data = analytic.train_samples(2, 2, H, 0, 300, 400)
        final = depth_engine.evaluate(res["graph"], data.val, opt, str(out), training=False, device="cpu")
        yield out, res, final
    finally:
        shutil.rmtree(out)


def test_depth_cli_writes_reference_checkpoints_and_best_val(run):
    out, res, final = run
    assert res["it"] == 1 and len(res["losses"]) == 1 and np.isfinite(res["losses"]).all()
    assert [ep for ep, _ in res["val"]] == [0, 1] and res["best_val"] == res["val"][1][1]  # epoch 0 is not kept
    for _, scalars in res["val_scalars"]:
        assert list(scalars) == [f"eval/{k}" for k in metric_keys()] and np.isfinite(list(scalars.values())).all()
    # with the visual dumps: vis_log/iter_0 at the save_vis cadence (the step counter starts at 0;
    # depth_engine.py:209-245) and the final evaluation's first batch (:296-319)
    assert sorted(os.listdir(out)) == ["best.ckpt", "best_val.txt", "checkpoint", "dump_synthetic", "latest.ckpt",
                                       "options.yaml", "vis_log"]
    assert os.listdir(out / "vis_log") == ["iter_0"]
    viz = sorted(os.listdir(out / "vis_log" / "iter_0"))
    names = ("depth_est.png", "depth_input.png", "image_input.png", "mask_input.png", "seen_surface.ply")
    assert viz == sorted(f"{i}_{n}" for i in {f.split("_")[0] for f in viz} for n in names), viz
    assert sorted(os.listdir(out / "dump_synthetic")) == [f"{i}_{n}" for i in (0, 1) for n in ("depth_est.png",
                                                                                              "image_input.png")]
    lines = open(out / "best_val.txt").read().splitlines()
    assert lines == [f"{k}: {final[k]:.6f}" for k in metric_keys()]  # depth_engine.py:290-293
    assert all(re.fullmatch(r"d>1\.\d+: \d\.\d{6}|(rmse|l1_err|abs_rel): \d+\.\d{6}", line) for line in lines)
    ckpt = torch.load(out / "best.ckpt", weights_only=True, mmap=True)
    assert set(ckpt) == {"graph", "epoch", "iter", "best_val", "best_ep", "optim"}
    assert {k.split(".")[0] for k in ckpt["graph"]} == {"dpt_depth", "intr_head", "intr_proj"}


def test_depth_evaluate_scores_eroded_masks_over_exactly_the_samples(run, tmp_path):
    """``evaluate`` scores ``mask_eroded`` where a sample has it, and takes
    the mean over exactly the samples given: 3 at eval batch 2 (a short last
    batch), against the metrics of each sample computed on its own."""
    _, res, _ = run
    from zeroshape_tpu_torch.data import analytic
    from zeroshape_tpu_torch.metrics.depth_metrics import compute_depth_metrics

    samples = analytic.train_samples(2, 2, H, 0, 300, 400).val
    samples = [dict(s, mask_eroded=s["mask_input_map"] * (np.arange(H) < H // 2)[None, :, None].astype(np.float32))
               for s in samples + samples[:1]]
    opt = train_options(["--task=depth"] + DEPTH)
    got = depth_engine.evaluate(res["graph"], samples, opt, str(tmp_path), training=True, device="cpu")
    graph = res["graph"].eval()
    per = {k: [] for k in metric_keys()}
    with torch.no_grad():
        for group in (samples[:2], samples[2:]):  # the batches evaluate forms (a batch's size moves the rounding)
            b = {k: torch.tensor(np.stack([smp[k] for smp in group])) for k in depth_engine.MODEL_KEYS + ("mask_eroded",)}
            out = graph(b, train=False)
            m, _ = compute_depth_metrics(*(x.permute(0, 3, 1, 2) for x in (out["depth_pred"], b["depth_input_map"],
                                                                               b["mask_eroded"])))
            for k in per:
                per[k] += m[k].tolist()
    graph.train()
    for k in metric_keys():
        assert len(per[k]) == 3
        np.testing.assert_allclose(got[k], np.mean(per[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    assert not os.listdir(tmp_path)  # validation writes no best_val.txt


def test_jax_importer_reads_the_depth_checkpoint(run):
    out, res, _ = run
    params, stats, report, meta = jckpt.load_torch_checkpoint(str(out / "best.ckpt"), graph="depth")
    assert report["missing"] == [] and report["unconsumed"] == []
    assert set(params) == {"dpt_depth", "intr_head"} and stats["intr_head"]
    assert meta["best_ep"] == res["best_ep"]


def _jax_shape_state(opt):
    """A JAX shape train state whose every leaf is zero (shapes from ``eval_shape``)."""
    model = JShapeGraph.from_opt(opt)
    b = {k: jnp.zeros(s) for k, s in (("rgb_input_map", (1, H, H, 3)), ("mask_input_map", (1, H, H, 1)),
                                     ("depth_input_map", (1, H, H, 1)), ("intr", (1, 3, 3)), ("pose_gt", (1, 3, 4)),
                                     ("gt_sample_points", (1, 8, 3)), ("gt_sample_sdf", (1, 8)))}
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                                               b, train=False))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return TrainState(step=0, params=zeros["params"], batch_stats=zeros["batch_stats"], opt_state=None, tx=None)


def test_staging_matches_the_jax_stage_pretrained(run):
    """A shape graph staged from the depth run's ``best.ckpt`` holds, on every
    ``dpt_depth`` / ``intr_head`` / ``intr_proj`` tensor, what the JAX
    ``stage_pretrained`` puts into its tree; the rest is left as it was."""
    out, _, _ = run
    opt = config.override_options(config.tiny_opt(H), {"pretrain": {"depth": str(out / "best.ckpt")}})
    staged = jckpt.stage_pretrained(_jax_shape_state(opt), opt, graph="shape")
    want = weights.from_flax(staged.params, staged.batch_stats, impl_mlp_linears=5)
    del staged
    graph = ShapeGraph.from_opt(opt)
    before = copy.deepcopy(graph.state_dict())
    assert checkpoint.stage_pretrained(graph, opt, "shape") == str(out / "best.ckpt")
    got = graph.state_dict()
    n = 0
    for k, v in want.items():
        if k.startswith(DEPTH_SUBTREES):
            assert torch.equal(got[k], v), k
            n += 1
    assert n > 300
    assert all(torch.equal(v, before[k]) for k, v in got.items() if not k.startswith(DEPTH_SUBTREES))


def _omnidata_file(run, change=None):
    """The depth run's DPT weights as an omnidata file (``model_state_dict``,
    keys unprefixed) in the run's directory, ``change(state_dict)`` applied
    to them first."""
    out, _, _ = run
    sd = torch.load(out / "best.ckpt", weights_only=True, mmap=True)["graph"]
    dpt = {k[len("dpt_depth."):]: v for k, v in sd.items() if k.startswith("dpt_depth.")}
    if change:
        change(dpt)
    path = out / "omnidata_dpt_depth_v2.ckpt"
    torch.save({"model_state_dict": dpt}, path)
    return path, sd


def test_omnidata_layout_stages_into_a_depth_graph(run):
    path, sd = _omnidata_file(run)
    _, _, report, _ = jckpt.load_torch_checkpoint(str(path))  # the JAX importer reads it as omnidata
    assert report["missing"] == []
    opt = config.override_options(config.depth_gen_opt(H), {"arch": {"depth": {"pretrained": str(path)}}})
    graph = DepthGraph.from_opt(opt)
    intr = copy.deepcopy({k: v for k, v in graph.state_dict().items() if k.startswith("intr_")})
    checkpoint.stage_pretrained(graph, opt, "depth")
    got = graph.state_dict()
    assert all(torch.equal(got[k], v) for k, v in sd.items() if k.startswith("dpt_depth."))
    assert all(torch.equal(got[k], v) for k, v in intr.items())  # omnidata holds no intrinsics head


def test_staging_refuses_what_it_cannot_load(run, tmp_path):
    graph = DepthGraph(H, H)

    def staged(path):
        opt = config.override_options(config.depth_gen_opt(H), {"arch": {"depth": {"pretrained": str(path)}}})
        checkpoint.stage_pretrained(graph, opt, "depth")

    with pytest.raises(FileNotFoundError, match="not found"):
        staged(tmp_path / "absent.ckpt")
    with pytest.raises(ValueError, match="directory"):
        staged(tmp_path)
    key = "scratch.output_conv.4.weight"
    path, _ = _omnidata_file(run, lambda sd: sd.update({key: sd[key][:, :1]}))
    with pytest.raises(ValueError, match="shape mismatch"):
        staged(path)
    path, _ = _omnidata_file(run, lambda sd: sd.pop(key))
    with pytest.raises(ValueError, match="missing 1 expected keys"):
        staged(path)
    shape = config.override_options(config.tiny_opt(H), {"pretrain": {"depth": str(tmp_path / "absent.ckpt")}})
    with pytest.raises(FileNotFoundError):
        checkpoint.stage_pretrained(ShapeGraph.from_opt(shape), shape, "shape")


def test_load_restores_weights_and_not_the_optimizer(run, tmp_path, capsys):
    out, _, _ = run
    opt = train_options(["--task=depth"] + DEPTH + [f"--load={out / 'latest.ckpt'}"])
    graph = DepthGraph.from_opt(opt)
    optimizer = ptrain.make_optimizer(graph, opt.optim)
    assert engine_base.start_run(opt, str(tmp_path), graph, optimizer) == (0, float("inf"), 1)
    want = torch.load(out / "latest.ckpt", weights_only=True, mmap=True)["graph"]
    assert all(torch.equal(v, want[k]) for k, v in graph.state_dict().items())
    assert optimizer.updates == 0 and not optimizer.adamw.state
    assert "missing" not in capsys.readouterr().out
    # a depth checkpoint over a shape graph: the coordinate encoder and decoder are missing, with a warning
    shape = ShapeGraph.from_opt(config.tiny_opt(H))
    checkpoint.load_weights(shape, str(out / "latest.ckpt"))
    assert re.search(r"warning: \d+ keys missing from ckpt", capsys.readouterr().out)
    assert torch.equal(shape.intr_proj.weight, want["intr_proj.weight"])


def _leaves(d, prefix=()):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(opt, path):
    for k in path:
        opt = opt[k]
    return opt


# keys of the YAML files that a preset need not match: where the data are and the loader's settings
NOT_READ = {("data", "root"), ("data", "num_workers"), ("data", "max_img_cat"), ("data", "bgcolor"),
            ("data", "pix3d", "cat"), ("data", "ocrtoc", "cat"), ("data", "ocrtoc", "erode_mask"),
            ("data", "synthetic", "percentage"), ("output_root",)}


def test_depth_gen_preset_is_the_yaml():
    ref = load_options(os.path.join(REPO, "options", "depth_gen.yaml")).to_dict()
    opt = config.depth_gen_opt()
    checked = 0
    for path, value in _leaves(ref):
        if path not in NOT_READ:
            assert _get(opt, path) == value, path
            checked += 1
    assert checked > 40 and opt.optim.lr_ft is None and opt.loss_weight.shape is None


def test_accuracy_gate_preset_is_the_gates_options(tmp_path):
    import test_accuracy_gate

    ref = yaml.safe_load(open(test_accuracy_gate.gate_yaml(tmp_path, tmp_path / "data")))
    opt = config.accuracy_gate_opt()
    checked = 0
    for path, value in _leaves(ref):
        if path not in NOT_READ:
            assert _get(opt, path) == value, path
            checked += 1
    assert checked > 50 and (opt.H, opt.W) == (64, 64) and opt.max_epoch == test_accuracy_gate.EPOCHS


@pytest.mark.parametrize("argv, task", [
    ([], "shape"), (["--yaml=options/depth_gen.yaml"], "depth"), (["--task=depth"], "depth"),
    (["--yaml=options/shape_gen.yaml"], "shape"), (["--task=shape", "--yaml=options/depth.yaml"], "shape"),
])
def test_cli_picks_the_engine_by_the_jax_rule(argv, task, monkeypatch):
    monkeypatch.chdir(REPO)
    opt = train_options(argv)
    assert opt.task == task and opt.loss_weight.shape == (None if task == "depth" else 1)
    with pytest.raises(ValueError, match="no 'render' engine"):
        train_options(["--task=render"])


def _decoder_of(opt):
    arch, impl = opt.arch, opt.arch.impl
    return Implicit(latent_dim=arch.latent_dim, n_channels=impl.n_channels, n_blocks_attn=impl.att_blocks,
                    n_layers_mlp=impl.mlp_layers, num_heads=arch.num_heads, mlp_ratio=impl.mlp_ratio,
                    skip_in=tuple(impl.skip_in))


@pytest.mark.parametrize("opt_fn, packs", [(config.full_opt, True), (lambda: config.tiny_opt(H), False),
                                           (config.accuracy_gate_opt, False)])
def test_repack_packs_only_the_kernels_decoder(opt_fn, packs):
    """On CUDA (the device's type is all ``repack`` reads) the shipped decoder
    is packed and any other keeps ``packed`` None; on the CPU nothing is."""
    graph = types.SimpleNamespace(impl_network=_decoder_of(opt_fn()))
    on_card = recon.ReconModel(graph, None, 1.0, torch.device("cuda")).repack()
    assert (on_card.packed is not None) == packs
    assert recon.ReconModel(graph, None, 1.0, torch.device("cpu")).repack().packed is None


@pytest.mark.parametrize("opt_fn, plain", [(config.full_opt, 0), (lambda: config.tiny_opt(H), 1)])
def test_decode_points_picks_the_decode_by_shape(opt_fn, plain):
    """A narrow decoder takes one plain decode of the batch (counted); the
    shipped one goes through the kernel's wrapper, one call a sample (the plain
    version on the CPU, not counted). Both give ``Implicit.decode``'s logits."""
    impl = _decoder_of(opt_fn()).eval()
    g = torch.Generator().manual_seed(0)
    model = types.SimpleNamespace(graph=types.SimpleNamespace(impl_network=impl), packed=None)
    before = recon.decode_points.plain_decodes
    with torch.inference_mode():
        caches = impl.encode(torch.randn(2, 197, impl.latent_proj.in_features, generator=g))
        pts = torch.rand(2, 50, 3, generator=g) * 3 - 1.5
        got = recon.decode_points(model, caches, pts)
        want = torch.stack([impl.decode([(k[b : b + 1], v[b : b + 1]) for k, v in caches], pts[b : b + 1])[0][0]
                            for b in range(2)])
    assert recon.decode_points.plain_decodes - before == plain
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
