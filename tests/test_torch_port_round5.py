"""The trained two-stage chain and its tools, on the CPU, held to the JAX
scripts: ``round5.run``'s plan with an injected stage runner against the
commands of ``scripts/round5_chain.sh`` / ``round5_after*.sh``,
``brute_force_search(rot_batch=...)`` against the JAX search,
``time_bf``'s sweep, ``calibrate_gate``'s and ``measure_hier``'s summary
lines against the JAX scripts' own, ``check_fused_engine``'s comparison and
its bounds, and the entry points' refusal without a card.

Tolerances: the scorer's (tests/test_torch_port_score.py), 1e-5 on the
metrics and 1e-6 on the rotation; ``time_bf``'s variants agree within 1e-6
(the JAX script's check); summaries and report lines are equal strings.
"""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshape_tpu.camera import get_rotation_sphere as j_rotation_sphere
from zeroshape_tpu.metrics import eval3d as je
from zeroshape_tpu_torch import calibrate_gate, check_fused_engine, config, measure_hier, recon, round5
from zeroshape_tpu_torch import save_random_init, time_bf
from zeroshape_tpu_torch.data import analytic
from zeroshape_tpu_torch.metrics import eval3d as te
from zeroshape_tpu_torch.models.graph_shape import ShapeGraph
from zeroshape_tpu_torch.train import options as train_options

from test_torch_harness import close, few_threads, give_memory_back, t  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROT = (6, 6, 4)  # 144 rotations: the CPU tests' sphere


def _script(name):
    """A module of ``scripts/`` (they are not a package)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# round5.run: the plan, with an injected stage runner
# ---------------------------------------------------------------------------

def _fake_stage(calls, fail=(), env_seen=None):
    """A stage runner that records each command and writes what the stage
    would: a training's checkpoints and validation lines, an evaluation's
    result files, the reports of measure_hier and calibrate_gate."""

    def runner(cmd, log_path, timeout, env, append=False):
        module, args = cmd[2].rsplit(".", 1)[1], cmd[3:]
        calls.append([module] + args)
        if env_seen is not None:
            env_seen.append(env)
        if module in fail:
            return 3
        lines = []
        if module in ("train", "evaluate", "save_random_init", "measure_hier"):
            opt = train_options(args, safe_check=False)
            os.makedirs(os.path.join(opt.output_path, "checkpoint"), exist_ok=True)
        if module in ("train", "save_random_init"):
            for name in ("best.ckpt", "latest.ckpt", f"checkpoint/ep{opt.max_epoch - 1}.ckpt"):
                open(os.path.join(opt.output_path, name), "w").close()
            if opt.task == "depth":
                lines = ["TRAINING START", "eval l1_err: 0.0742", "validating epoch 1", "eval l1_err: 0.0290",
                         "Best l1_err: 0.0290 @ epoch 1"]
            else:
                lines = ["TRAINING START", "CD. ACC: 0.2000, COMP: 0.2644", "validating epoch 1",
                         "CD. ACC: 0.0300, COMP: 0.0410", "Best CD: 0.0355 @ epoch 1"]
        elif module == "evaluate":
            with open(os.path.join(opt.output_path, "quantitative_synthetic.txt"), "w") as f:
                f.write("CD     Acc    Comp \n0.0356 0.0300 0.0412\nF-score @ 5.00: 0.8670\n")
            with open(os.path.join(opt.output_path, "cd_cat.txt"), "w") as f:
                f.write("CD     Acc    Comp   Count Cat\n0.0300 0.0300 0.0300     2 ho0\n"
                        "0.0400 0.0400 0.0400     2 ho1\n0.0369 0.0369 0.0369     1 prim\n")
        elif module == "measure_hier":
            counts = np.array([760, 1289, 2149, 2210])
            lines = measure_hier.report(counts, 128, opt.name) + measure_hier.report(counts + 100, 128, "shape_gen")
        elif module == "calibrate_gate":
            lines = ["seed 0: best CD 0.0711 (20 s)", "seed 1: best CD 0.0813 (21 s)", "seed 2: best CD 0.0585 (20 s)"]
            lines += calibrate_gate.summary([0.0711, 0.0813, 0.0585])
        with open(log_path, "a" if append else "w") as f:
            f.write("\n".join(lines) + "\n")
        return 0

    return runner


def _expected(out, P, gate=("3",)):
    """The JAX chain's commands (scripts/round5_chain.sh, round5_after3.sh),
    translated to the port's CLIs, with ``P``, the options every stage is given."""
    best = {n: os.path.join(out, g, n, "best.ckpt") for g, n in (("depth", "depth_gen"), ("shape", "shape_gen_staged"),
                                                                ("shape", "shape_gen"), ("shape", "shape_gen_rand"))}
    return [
        ["train", "--task=depth"] + P,
        ["train", "--task=shape", "--name=shape_gen_staged", f"--pretrain.depth={best['depth_gen']}"] + P,
        ["train", "--task=shape"] + P,
        ["evaluate", "--task=shape", "--name=shape_gen_staged", "--resume"] + P,
        ["evaluate", "--task=shape", "--name=shape_gen", "--resume"] + P,
        ["evaluate", "--task=shape", "--name=shape_gen_bf", f"--ckpt={best['shape_gen_staged']}",
         "--eval.brute_force"] + P,
        ["measure_hier", "--task=shape", "--name=shape_gen_staged", "--resume",
         f"--extra_ckpts={best['shape_gen']}"] + P,
        ["save_random_init", "--task=shape", "--name=shape_gen_rand"] + P,
        ["evaluate", "--task=shape", "--name=shape_gen_rand", f"--ckpt={best['shape_gen_rand']}",
         "--eval.dump_mesh_viz!"] + P,
        ["calibrate_gate", *gate],
    ]


def test_jax_chain_commands_are_the_ones_translated():
    """Every JAX command that ``_expected`` translates is in the JAX scripts."""
    chain = open(os.path.join(REPO, "scripts", "round5_chain.sh")).read()
    after = open(os.path.join(REPO, "scripts", "round5_after.sh")).read()
    after3 = open(os.path.join(REPO, "scripts", "round5_after3.sh")).read()
    for frag in ("train.py --yaml=options/depth_gen.yaml", "--name=shape_gen_staged \\\n    "
                 "--pretrain.depth=output/depth/depth_gen/best.ckpt", "train.py --yaml=options/shape_gen.yaml \\\n  >",
                 "--name=$name --resume", "--name=shape_gen_bf --ckpt=$BFCKPT --eval.brute_force"):
        assert frag in chain, frag
    for frag in ("save_random_init.py --yaml=options/shape_gen.yaml \\\n  --name=shape_gen_rand",
                 "--ckpt=output/shape/shape_gen_rand/best.ckpt \\\n    --eval.dump_mesh_viz!", "calibrate_gate.py 3"):
        assert frag in after, frag
    assert "--name=shape_gen_staged --resume \\\n  --extra_ckpts=output/shape/shape_gen/best.ckpt" in after3


def test_chain_runs_the_jax_stages_in_order_and_reads_their_results(tmp_path, capsys, monkeypatch):
    data, out = tmp_path / "data", tmp_path / "out"
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    calls, envs = [], []
    argv = [f"--data.root={data}", "--max_epoch=1", f"--output_root={out}"]
    rc, res = round5.run(argv, _fake_stage(calls, env_seen=envs))
    assert rc == 0 and calls == _expected(out, argv)
    assert all("RANK" not in e and "MASTER_PORT" not in e and REPO in e["PYTHONPATH"] for e in envs)
    printed = capsys.readouterr().out.splitlines()
    for name in ("depth", "staged", "scratch", "eval_staged", "eval_scratch", "bf", "hier", "rand", "rand_eval", "gate"):
        assert any(line.startswith(f"[chain] {name} exit 0 ") for line in printed), name
    assert json.loads(printed[-1]) == res == json.load(open(out / "round5" / "results.json"))
    assert res["depth"]["l1_err_epoch0"] == 0.0742 and res["depth"]["l1_err_best"] == 0.0290
    for arm in ("staged", "scratch"):
        assert res[arm]["cd_epoch0"] == pytest.approx(0.2322) and res[arm]["cd_best"] == pytest.approx(0.0355)
        assert res[arm]["best_epoch"] == 1
    assert res["eval_staged"]["cd"] == 0.0356 and res["eval_staged"]["seen"] == 0.0369
    assert res["eval_staged"]["unseen"] == pytest.approx(0.035) and res["bf"]["f_score"]["5.00"] == 0.867
    assert res["hier"]["shape_gen_staged"] == {"min": 760, "median": 1719, "p95": 2200, "max": 2210,
                                               "overflow": {"2048": "2/4", "4096": "0/4"}}
    assert res["hier"]["shape_gen"]["max"] == 2310 and res["floor"]["cd"] == 0.0356
    assert res["gate"]["seeds"] == [0.0711, 0.0813, 0.0585] and res["gate"]["mean"] == 0.0703
    assert res["failed"] == []

    # a second run finds every output and runs nothing
    calls.clear()
    rc, again = round5.run([f"--data.root={data}", "--max_epoch=1", f"--output_root={out}"], _fake_stage(calls))
    assert rc == 0 and calls == [] and {s["status"] for s in again["stages"].values()} == {"done"}
    assert again["eval_scratch"] == res["eval_scratch"] and again["gate"] == res["gate"]


def test_a_cut_chain_resumes_and_a_failed_stage_fails_the_chain(tmp_path, capsys):
    data, out = tmp_path / "data", tmp_path / "out"
    base = [f"--data.root={data}", f"--output_root={out}", "--max_epoch=1"]
    calls = []
    rc, res = round5.run(base, _fake_stage(calls, fail=("train",)))
    printed = capsys.readouterr().out
    assert rc == 1 and res["failed"] == ["depth", "scratch"]
    assert f"[chain] SKIP staged: no {out}/depth/depth_gen/best.ckpt" in printed
    for name in ("staged", "eval_staged", "eval_scratch", "bf", "hier"):
        assert res["stages"][name]["status"] == "skipped", name
    assert "depth" not in res and "staged" not in res and "gate" in res and "floor" in res  # no result of a failure
    assert [c[0] for c in calls] == ["train", "train", "save_random_init", "evaluate", "calibrate_gate"]

    # a training cut midway (its latest.ckpt, no last checkpoint) resumes; finished stages are not run again
    os.makedirs(out / "depth" / "depth_gen", exist_ok=True)
    open(out / "depth" / "depth_gen" / "latest.ckpt", "w").close()
    calls.clear()
    rc, res = round5.run(base, _fake_stage(calls))
    assert rc == 0 and calls[0][:2] == ["train", "--task=depth"] and "--resume" in calls[0]
    assert [c[0] for c in calls] == ["train", "train", "train", "evaluate", "evaluate", "evaluate", "measure_hier"]
    assert res["stages"]["rand"]["status"] == res["stages"]["gate"]["status"] == "done"


def test_two_jobs_keep_every_stage_after_what_it_reads(tmp_path):
    data, out = tmp_path / "data", tmp_path / "out"
    calls = []
    rc, res = round5.run([f"--data.root={data}", f"--output_root={out}", "--jobs=2", "--gate_seeds=2",
                          "--device=cpu"], _fake_stage(calls))
    want = _expected(out, [f"--data.root={data}", f"--output_root={out}", "--device=cpu"], ("2", "--device=cpu"))
    assert rc == 0 and sorted(map(tuple, calls)) == sorted(map(tuple, want))
    depth = next(i for i, c in enumerate(calls) if c[:2] == ["train", "--task=depth"])
    staged = next(i for i, c in enumerate(calls) if "--name=shape_gen_staged" in c and c[0] == "train")
    assert staged > depth
    with pytest.raises(ValueError, match="sets"):
        round5.run([f"--output_root={out}", "--name=x"], _fake_stage([]))


# ---------------------------------------------------------------------------
# the scorer's rot_batch, time_bf, the summaries
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def clouds():
    """A jittered box's GT cloud and an independent draw of it, rotated by a
    sphere rotation: a search with one clear winner."""
    rng = np.random.default_rng(3)
    sdf, _ = analytic.make_sdf("box", rng)
    gt = analytic.surface_points(sdf, 512, rng)
    pred = analytic.surface_points(sdf, 384, rng)
    R = np.asarray(j_rotation_sphere(*ROT))[77]
    return (pred @ R).astype(np.float32), gt


@pytest.mark.parametrize("prune", [None, (1024, 128)])
def test_brute_force_rot_batch_changes_nothing(clouds, prune):
    pred, gt = clouds
    got = {rb: te.brute_force_search(t(pred), t(gt), rot_samples=ROT, prune=prune, rot_batch=rb) for rb in (48, 128)}
    for k in ("acc", "comp", "f_score", "rotation", "pc_pred"):
        assert torch.equal(got[48][k], got[128][k]), k
    assert torch.equal(te.brute_force_search(t(pred), t(gt), rot_samples=ROT, prune=prune)["acc"], got[48]["acc"])
    for rb in (48, 128):
        want = je.brute_force_search(jnp.asarray(pred), jnp.asarray(gt), use_pallas=False, rot_samples=ROT,
                                     prune=prune, rot_batch=rb)
        close(got[rb]["rotation"], want["rotation"], 1e-6)
        for k in ("acc", "comp", "f_score"):
            close(got[rb][k], want[k], 1e-5, k)


def test_time_bf_variants_keep_the_search_invariants_and_match_jax(capsys):
    pred, gt = time_bf.clouds(300)
    with torch.inference_mode():
        rows = time_bf.sweep(t(pred), t(gt), reps=1, rot_samples=ROT)
    printed = capsys.readouterr().out.splitlines()
    assert [(r[0], r[1]) for r in rows] == list(time_bf.VARIANTS) and len(printed) == 6
    assert time_bf.invariants(rows) == (True, True)
    for rot_batch, prune, _, cd in (rows[0], rows[-1]):  # the default and the exhaustive search
        want = je.brute_force_search(jnp.asarray(pred), jnp.asarray(gt), use_pallas=False, rot_samples=ROT,
                                     prune=prune, rot_batch=rot_batch)
        assert abs(cd - float((want["acc"] + want["comp"]) / 2)) <= 1e-5, (rot_batch, prune)
    # the invariants bite: a rot_batch that changed the result, a prune below the exhaustive search
    assert time_bf.invariants([(48, (4, 2), 0, 0.2), (128, (4, 2), 0, 0.3), (48, None, 0, 0.1)]) == (False, True)
    assert time_bf.invariants([(48, (4, 2), 0, 0.05), (48, None, 0, 0.1)]) == (True, False)


@pytest.mark.parametrize("cds", [[0.0711, 0.0813, 0.0585], [0.0576], [0.0576, 0.0496]])
def test_calibrate_gate_summary_is_the_jax_scripts(cds, capsys, monkeypatch, tmp_path):
    jgate = _script("calibrate_gate")
    monkeypatch.setattr(jgate, "run_seed", lambda seed, tmp, root: cds[seed])
    monkeypatch.setattr("zeroshape_tpu.data.analytic.generate_dataset", lambda *a, **k: None)
    monkeypatch.setattr(jgate.tempfile, "mkdtemp", lambda prefix="": str(tmp_path))
    monkeypatch.setattr(jgate.sys, "argv", ["calibrate_gate.py", str(len(cds))])
    jgate.main()
    text = capsys.readouterr().out
    want = text[text.index("\nseeds:"):]
    print("\n".join(calibrate_gate.summary(cds)))
    assert capsys.readouterr().out == want


def test_measure_hier_report_is_the_jax_scripts(capsys):
    jhier = _script("measure_hier")
    counts = np.array([760, 1289, 1638, 2149, 2210, 2533, 4097, 9000])
    for vox in (128, 64):
        jhier.report(counts, vox, "shape_gen_staged")
        want = capsys.readouterr().out
        measure_hier.report(counts, vox, "shape_gen_staged")
        assert capsys.readouterr().out == want


# ---------------------------------------------------------------------------
# check_fused_engine's comparison, and the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_model():
    torch.manual_seed(0)
    graph = ShapeGraph.from_opt(config.tiny_opt(32)).eval()
    rgb, mask = config.synthetic_image(32, seed=1)
    return recon.ReconModel(graph, None, 25.0, torch.device("cpu")), {"rgb_input_map": rgb, "mask_input_map": mask}


def test_check_fused_engine_compares_and_its_bound_bites(tiny_model, monkeypatch):
    """On the CPU both models decode plainly in fp32, as the yardstick does: no
    difference, and the check passes. A stand-in "kernel" whose logits have the
    wrong sign is far from the fp32 decode where the plain decode is not: it fails."""
    model, batch = tiny_model
    same = check_fused_engine.compare(model, batch, vox=32, capacity=64)
    assert same["ok"] and same["max"] == 0.0 and same["flips"] == 0
    assert same["err_k1"] == same["err_plain"] == (0.0, 0.0) and same["flips_k1"] == same["flips_plain"] == 0
    assert same["n_active_plain"] == same["n_active_fused"] == same["n_active_fp32"] > 0
    plain_decode = recon.decode_points

    def inside_out(m, caches, pts):
        logits = plain_decode(m, caches, pts)
        return -logits if m.fused else logits

    inside_out.plain_decodes = 0
    monkeypatch.setattr(recon, "decode_points", inside_out)
    bad = check_fused_engine.compare(model, batch, vox=32, capacity=64)
    assert not bad["ok"] and bad["err_k1"][0] > 0 and bad["err_plain"] == (0.0, 0.0)
    assert bad["flip_share"] > 0.5 and bad["flips_k1"] == bad["flips"] and bad["flips_plain"] == 0
    assert bad["n_active_plain"] == bad["n_active_fused"]  # the margin test is symmetric about 0.5


@pytest.mark.parametrize("main", [save_random_init.main, measure_hier.main, check_fused_engine.main, time_bf.main,
                                  calibrate_gate.main])
def test_the_tools_need_the_card(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])
