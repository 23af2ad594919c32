"""The analytic two-stage recipe end to end, then the measurements on its
trained fields (counterpart of ``scripts/round5_chain.sh`` and
``scripts/round5_after.sh``).

    python -m zeroshape_tpu_torch.generalize_e2e gen [DIR]          # the data (default /tmp/gen_data)
    python -m zeroshape_tpu_torch.round5 run [--data.root=DIR] [--output_root=output] [--log_dir=DIR] \\
        [--jobs=1] [--gate_seeds=3] [--key=value ...]

Each stage is a subprocess of one of the port's CLIs, in the JAX chain's
order, with the JAX script's timeout:

1. ``depth``: ``train --task=depth`` (``depth_gen``; 7200 s);
2. ``staged``: ``train --task=shape --name=shape_gen_staged
   --pretrain.depth=<depth>/best.ckpt`` (10800 s);
3. ``scratch``: ``train --task=shape`` (``shape_gen``; 10800 s);
4. ``eval_staged``, ``eval_scratch``: ``evaluate --task=shape --name=<arm>
   --resume``, the exact dense protocol (5400 s each);
5. ``bf``: ``evaluate --task=shape --name=shape_gen_bf --ckpt=<staged best,
   else scratch best> --eval.brute_force``, the exact brute force in a
   directory of its own (10800 s);
6. ``hier``: ``measure_hier --task=shape --name=shape_gen_staged --resume
   --extra_ckpts=<scratch best>``, both arms in one process (3600 s);
7. ``rand``: ``save_random_init --task=shape --name=shape_gen_rand`` (1800
   s), and ``rand_eval``: ``evaluate --task=shape --name=shape_gen_rand
   --ckpt=<it> --eval.dump_mesh_viz!`` (the floor; its meshes are noise, so
   no turntables; 5400 s);
8. ``gate``: ``calibrate_gate <gate_seeds>`` (10800 s).

As in the JAX chain, a stage whose input checkpoint is missing is skipped,
and the skip is printed. Unlike a shell chain, a stage whose own output
already exists is skipped too, so a chain that was cut resumes where it
stopped: a training's output is its run's last checkpoint
(``checkpoint/ep{max_epoch-1}.ckpt``, written when the training ends; one
cut midway is started again with ``--resume`` from its ``latest.ckpt``),
an evaluation's its ``quantitative_{dataset}.txt``, and ``hier``'s and
``gate``'s their log, kept as ``<log_dir>/<stage>.txt`` once they exit 0.

Every ``--key=value`` option other than the chain's own (``--jobs``,
``--log_dir``, ``--gate_seeds``) goes to every train, evaluate,
``measure_hier`` and ``save_random_init`` stage after the stage's own
arguments, ``--output_root`` and ``--device`` included (``--device`` also to
``calibrate_gate``): ``--max_epoch=1 --freq.eval=1`` cuts a run's epochs.
The depth run takes those that its options hold or the shape runs' do not
(the train CLI checks its keys, and ``--eval.vox_res`` or the decoder's
width are no depth option).
The chain sets each run's name, staging and weights itself, so it refuses
``--name``, ``--pretrain``, ``--resume``, ``--ckpt``, ``--load``, ``--task``,
``--yaml`` and ``--output_path``. ``--jobs=N`` runs up to N stages at a
time, each as soon as the stages it reads have ended (the depth stage beside
the scratch arm, the evaluations beside the staged arm); 1 keeps the JAX
order. The stages start in a clean environment: no ``torchrun`` variable is
passed on, so none joins a process group it did not start. SIGTERM or
SIGINT kills the running stages with the chain.

Each stage's output goes to ``<log_dir>/<stage>.log`` (default
``<output_root>/round5``; a training's log grows across resumes), and the
chain prints ``[chain] <stage> exit <rc> <seconds>``. At the end it prints
one JSON line, also written to ``<log_dir>/results.json``: the depth
stage's ``l1_err`` curve, both arms' validation CD at epoch 0 and at their
best (with its epoch), both evaluations' CD with the seen (``prim``) and
unseen (``ho*``) rows of ``cd_cat.txt``, the brute force's CD and F-scores,
the ``n_active`` statistics, the random floor's CD, the gate's seeds, and
each stage's exit code and seconds. A stage that failed gives no result; the
chain then exits 1.

Disk: a full-width checkpoint is ~2.3 GB (a depth one ~1.7 GB); each
training keeps ``best``, ``latest`` and its last epoch's, so the chain holds
about 24 GB under ``output_root`` at the full recipe.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass, field

from zeroshape_tpu_torch.config import parse_arguments

OWN = ("jobs", "log_dir", "gate_seeds")
REFUSED = ("name", "pretrain", "resume", "ckpt", "load", "task", "yaml", "output_path")
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK", "GROUP_WORLD_SIZE",
                 "ROLE_RANK", "ROLE_NAME", "ROLE_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LIVE = set()  # the stage processes running now


@dataclass
class Stage:
    """One stage: ``argv()`` gives the module's arguments and the missing
    input (None when every input exists) at the moment the stage starts."""

    name: str
    module: str
    argv: callable
    output: str
    timeout: int
    after: tuple = ()
    train: bool = False  # a training: resumed from latest.ckpt when cut
    latest: str | None = None
    result: str | None = None  # the log kept as the stage's output
    passed: list | None = None  # the chain's options this stage takes (None: all)


@dataclass
class Chain:
    passed: list  # the options given to every stage that takes the train CLI's
    log_dir: str
    gate_seeds: int = 3
    jobs: int = 1
    device: str | None = None
    outcome: dict = field(default_factory=dict)


def run_options(passed, task, name=None):
    """The options a stage run of ``task`` named ``name`` resolves (the CLIs' own rules)."""
    from zeroshape_tpu_torch.train import options

    return options([f"--task={task}"] + ([f"--name={name}"] if name else []) + passed, safe_check=False)


def _holds(opt, arg):
    """Whether ``opt`` holds the dotted key of the option ``arg``."""
    for key in arg.lstrip("-").split("=")[0].rstrip("!").split("."):
        if not isinstance(opt, dict) or key not in opt:
            return False
        opt = opt[key]
    return True


def plan(chain):
    """The stages, in the JAX chain's order."""
    p = chain.passed
    depth, staged, scratch = (run_options(p, t, n) for t, n in (("depth", None), ("shape", "shape_gen_staged"),
                                                                  ("shape", None)))
    # a shape run's key that the depth options lack (the decoder, the grid) is not the depth run's
    bare_depth, bare_shape = run_options([], "depth"), run_options([], "shape")
    depth_passed = [a for a in p if _holds(bare_depth, a) or not _holds(bare_shape, a)]
    bf_opt, rand = run_options(p, "shape", "shape_gen_bf"), run_options(p, "shape", "shape_gen_rand")
    best = {k: os.path.join(o.output_path, "best.ckpt") for k, o in (("depth", depth), ("staged", staged),
                                                                      ("scratch", scratch), ("rand", rand))}

    def last(o):
        return os.path.join(o.output_path, "checkpoint", f"ep{o.max_epoch - 1}.ckpt")

    def quantitative(o):
        return os.path.join(o.output_path, f"quantitative_{o.data.dataset_test}.txt")

    def needs(args, *paths):
        return lambda: (args, next((q for q in paths if not os.path.isfile(q)), None))

    def bf_args():
        ckpt = best["staged"] if os.path.isfile(best["staged"]) else best["scratch"]
        return ["--task=shape", "--name=shape_gen_bf", f"--ckpt={ckpt}", "--eval.brute_force"], \
            None if os.path.isfile(ckpt) else ckpt

    def hier_args():
        arms = [(n, best[k]) for n, k in (("shape_gen_staged", "staged"), ("shape_gen", "scratch"))
                if os.path.isfile(best[k])]
        if not arms:
            return [], best["staged"]
        extra = [f"--extra_ckpts={','.join(path for _, path in arms[1:])}"] if len(arms) > 1 else []
        return ["--task=shape", f"--name={arms[0][0]}", "--resume"] + extra, None

    log = lambda name: os.path.join(chain.log_dir, f"{name}.txt")  # noqa: E731
    gate = [str(chain.gate_seeds)] + ([f"--device={chain.device}"] if chain.device else [])
    return [
        Stage("depth", "train", needs(["--task=depth"]), last(depth), 7200, train=True,
              latest=os.path.join(depth.output_path, "latest.ckpt"), passed=depth_passed),
        Stage("staged", "train", needs(["--task=shape", "--name=shape_gen_staged",
                                        f"--pretrain.depth={best['depth']}"], best["depth"]),
              last(staged), 10800, after=("depth",), train=True, latest=os.path.join(staged.output_path, "latest.ckpt")),
        Stage("scratch", "train", needs(["--task=shape"]), last(scratch), 10800, train=True,
              latest=os.path.join(scratch.output_path, "latest.ckpt")),
        Stage("eval_staged", "evaluate", needs(["--task=shape", "--name=shape_gen_staged", "--resume"], best["staged"]),
              quantitative(staged), 5400, after=("staged",)),
        Stage("eval_scratch", "evaluate", needs(["--task=shape", "--name=shape_gen", "--resume"], best["scratch"]),
              quantitative(scratch), 5400, after=("scratch",)),
        Stage("bf", "evaluate", bf_args, quantitative(bf_opt), 10800, after=("staged", "scratch")),
        Stage("hier", "measure_hier", hier_args, log("hier"), 3600, after=("staged", "scratch"), result=log("hier")),
        Stage("rand", "save_random_init", needs(["--task=shape", "--name=shape_gen_rand"]), best["rand"], 1800),
        Stage("rand_eval", "evaluate", needs(["--task=shape", "--name=shape_gen_rand", f"--ckpt={best['rand']}",
                                              "--eval.dump_mesh_viz!"], best["rand"]),
              quantitative(rand), 5400, after=("rand",)),
        Stage("gate", "calibrate_gate", lambda: (gate, None), log("gate"), 10800, result=log("gate")),
    ]


def stage_env():
    """The environment of a stage: this one without ``torchrun``'s variables,
    the repo on ``PYTHONPATH``."""
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_VARS and not k.startswith("TORCHELASTIC_")}
    env["PYTHONPATH"] = os.pathsep.join([REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def run_subprocess(cmd, log_path, timeout, env, append=False):
    """Run ``cmd`` with its output into ``log_path``; its exit code, 124 when
    ``timeout`` cut it. The process's whole group is killed on a timeout or
    when this call is interrupted."""
    with open(log_path, "a" if append else "w") as log:
        log.write(f"[chain] {' '.join(cmd)}\n")
        log.flush()
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env, start_new_session=True)
        _LIVE.add(proc)
        try:
            return proc.wait(timeout)
        except subprocess.TimeoutExpired:
            return 124
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            _LIVE.discard(proc)


def _stop(signum, frame):
    """SIGTERM / SIGINT: kill every running stage's process group, then exit."""
    for proc in list(_LIVE):
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    os._exit(128 + signum)


def start(stage, chain, runner):
    """``(status, rc, seconds)`` of one stage: ``done`` (its output exists),
    ``skipped`` (an input is missing), else it runs: ``ok`` or ``failed``."""
    if os.path.exists(stage.output):
        print(f"[chain] {stage.name} done already ({stage.output})", flush=True)
        return "done", 0, 0.0
    args, missing = stage.argv()
    if missing:
        print(f"[chain] SKIP {stage.name}: no {missing}", flush=True)
        return "skipped", None, 0.0
    passed = [] if stage.module == "calibrate_gate" else chain.passed if stage.passed is None else stage.passed
    resume = ["--resume"] if stage.train and os.path.isfile(stage.latest) else []
    cmd = [sys.executable, "-m", f"zeroshape_tpu_torch.{stage.module}"] + args + resume + passed
    print(f"[chain] {stage.name}: {' '.join(cmd[2:])}", flush=True)
    log_path = os.path.join(chain.log_dir, f"{stage.name}.log")
    t0 = time.perf_counter()
    rc = runner(cmd, log_path, stage.timeout, stage_env(), append=stage.train)
    seconds = time.perf_counter() - t0
    print(f"[chain] {stage.name} exit {rc} {seconds:.1f}", flush=True)
    if rc == 0 and stage.result:
        shutil.copyfile(log_path, stage.result)
    return ("ok" if rc == 0 else "failed"), rc, seconds


def execute(stages, chain, runner):
    """Run ``stages``, up to ``chain.jobs`` at a time, each once the stages it
    reads have ended, in list order among those ready. Fills ``chain.outcome``."""
    pending, running = list(stages), {}
    with ThreadPoolExecutor(max(chain.jobs, 1)) as pool:
        while pending or running:
            for st in list(pending):
                if len(running) >= chain.jobs:
                    break
                if all(a in chain.outcome for a in st.after):
                    pending.remove(st)
                    running[pool.submit(start, st, chain, runner)] = st
            if running:
                done, _ = wait(running, return_when=FIRST_COMPLETED)
                for fut in done:
                    chain.outcome[running.pop(fut).name] = fut.result()
    return chain.outcome


# -- results, read back from the stages' logs and files ---------------------

def val_curve(text, metric):
    """``[[epoch, value]]`` of a training log's validations: the shape
    engine's ``CD. ACC: a, COMP: b`` (CD = (a + b) / 2) or the depth
    engine's ``eval l1_err: x``; epoch 0 before the first step, then the
    epoch of each ``validating epoch N``."""
    curve, ep = [], 0
    for line in text.splitlines():
        if "TRAINING START" in line:
            ep = 0
        elif (m := re.search(r"validating epoch (\d+)", line)):
            ep = int(m[1])
        elif metric == "CD" and (m := re.search(r"CD\. ACC: ([-\d.eE+naif]+), COMP: ([-\d.eE+naif]+)", line)):
            curve.append([ep, (float(m[1]) + float(m[2])) / 2])
        elif metric != "CD" and (m := re.search(rf"eval {metric}: ([-\d.eE+naif]+)", line)):
            curve.append([ep, float(m[1])])
    return curve


def curve_summary(text, metric, key):
    """A training log's validations: epoch 0's value, the best the engine kept
    (its ``Best <metric>: v @ epoch n`` line; epoch 0 is never kept) and the
    curve."""
    curve = val_curve(text, metric)
    best = re.findall(rf"Best {metric}: ([-\d.eE+naif]+) @ epoch (\d+)", text)
    if not curve or not best:
        return None
    first = next((v for e, v in curve if e == 0), None)
    return {f"{key}_epoch0": first, f"{key}_best": float(best[-1][0]), "best_epoch": int(best[-1][1]), "curve": curve}


def eval_result(path):
    """CD, Acc, Comp and F-scores of a ``quantitative_{dataset}.txt``, and the
    ``cd_cat.txt`` beside it: each category's row, ``seen`` (``prim``) and
    ``unseen`` (the ``ho*`` rows, weighted by their counts)."""
    lines = open(path).read().splitlines()
    cd, acc, comp = (float(x) for x in lines[1].split())
    fs = {m[1]: float(m[2]) for m in (re.match(r"F-score @ ([\d.]+): ([\d.]+)", x) for x in lines[2:]) if m}
    out = {"cd": cd, "acc": acc, "comp": comp, "f_score": fs}
    cat_path = os.path.join(os.path.dirname(path), "cd_cat.txt")
    if os.path.isfile(cat_path):
        rows = [x.split() for x in open(cat_path).read().splitlines()[1:] if x.strip()]
        cats = {r[4]: {"cd": float(r[0]), "count": int(r[3])} for r in rows}
        held = [c for n, c in cats.items() if n.startswith("ho")]
        out["cats"] = cats
        out["seen"] = cats["prim"]["cd"] if "prim" in cats else None
        out["unseen"] = sum(c["cd"] * c["count"] for c in held) / sum(c["count"] for c in held) if held else None
    return out


def hier_result(text):
    """``{label: {min, median, p95, max, overflow: {capacity: "k/N"}}}`` of ``measure_hier``'s report."""
    out = {}
    for m in re.finditer(r"\[(\S+)\] n_active: min=(\d+) median=(\d+) p95=(\d+) max=(\d+)", text):
        out[m[1]] = {"min": int(m[2]), "median": int(m[3]), "p95": int(m[4]), "max": int(m[5]), "overflow": {}}
    for m in re.finditer(r"\[(\S+)\]   capacity (\d+): (\d+/\d+) samples would overflow", text):
        out[m[1]]["overflow"][m[2]] = m[3]
    return out


def gate_result(text):
    seeds = [(int(m[1]), float(m[2]), int(m[3])) for m in re.finditer(r"seed (\d+): best CD ([\d.]+) \((\d+) s\)", text)]
    m = re.search(r"mean ([\d.]+), sigma ([\d.]+)", text)
    return {"seeds": [s[1] for s in seeds], "seconds": [s[2] for s in seeds],
            "mean": float(m[1]) if m else None, "sigma": float(m[2]) if m else None}


def results(chain, stages):
    """The chain's results, from the stages that ended well (or had ended before)."""
    by = {s.name: s for s in stages}
    good = {n for n, (status, _, _) in chain.outcome.items() if status in ("ok", "done")}
    text = lambda n: open(os.path.join(chain.log_dir, f"{n}.log")).read() \
        if os.path.isfile(os.path.join(chain.log_dir, f"{n}.log")) else ""  # noqa: E731
    out = {"stages": {n: {"status": s, "rc": rc, "seconds": round(sec, 1)} for n, (s, rc, sec) in chain.outcome.items()}}
    if "depth" in good:
        out["depth"] = curve_summary(text("depth"), "l1_err", "l1_err")
    for arm in ("staged", "scratch"):
        if arm in good:
            out[arm] = curve_summary(text(arm), "CD", "cd")
    for name, key in (("eval_staged", "eval_staged"), ("eval_scratch", "eval_scratch"), ("bf", "bf"),
                      ("rand_eval", "floor")):
        if name in good:
            out[key] = eval_result(by[name].output)
    if "hier" in good:
        out["hier"] = hier_result(open(by["hier"].output).read())
    if "gate" in good:
        out["gate"] = gate_result(open(by["gate"].output).read())
    return out


def run(argv, runner=run_subprocess):
    """The chain over ``argv`` (``run``'s options); returns ``(exit code, results)``."""
    cli = parse_arguments(argv)
    refused = [k for k in REFUSED if k in cli]
    if refused:
        raise ValueError(f"the chain sets {refused} for each stage itself")
    output_root = cli.get("output_root") or "output"
    chain = Chain(passed=[a for a in argv if a.lstrip("-").split("=")[0].split(".")[0] not in OWN]
                  + ([] if "output_root" in cli else [f"--output_root={output_root}"]),
                  log_dir=cli.get("log_dir") or os.path.join(output_root, "round5"),
                  gate_seeds=int(cli.get("gate_seeds") or 3), jobs=int(cli.get("jobs") or 1), device=cli.get("device"))
    os.makedirs(chain.log_dir, exist_ok=True)
    stages = plan(chain)
    t0 = time.perf_counter()
    handlers = {sig: signal.signal(sig, _stop) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        execute(stages, chain, runner)
    finally:
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
    out = results(chain, stages)
    failed = sorted(n for n, (s, _, _) in chain.outcome.items() if s == "failed")
    out["failed"], out["seconds"] = failed, round(time.perf_counter() - t0, 1)
    with open(os.path.join(chain.log_dir, "results.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return (1 if failed else 0), out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] != "run":
        raise SystemExit(__doc__)
    rc, _ = run(argv[1:])
    sys.exit(rc)


if __name__ == "__main__":
    main()
