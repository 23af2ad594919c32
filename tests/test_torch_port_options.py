"""The train CLI's options guard against the JAX CLI's (``zeroshape_tpu/config.py``
``override_options(safe_check=True)``, ``process_options``,
``save_options_file``, ``_diff_options``; ``train.py:51-52``): unknown keys
raise and name themselves, the port's own CLI keys pass, the resolved
options go to ``options.yaml`` (read back equal by ``yaml.safe_load``, with
and without PyYAML importable), a changed run prints the JAX diff lines, and
the name suffix and ``freq.eval`` follow ``process_options``.
"""

import os
import re
import subprocess
import sys

import pytest
import yaml

from zeroshape_tpu.config import Config as JConfig
from zeroshape_tpu.config import _diff_options as jax_diff
from zeroshape_tpu.config import parse_arguments as jax_parse
from zeroshape_tpu.config import process_options as jax_process
from zeroshape_tpu.config import set_options as jax_set_options
from zeroshape_tpu_torch import config, train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("typo, key", [("--optim.lrr=5e-3", "optim.lrr"), ("--max_epochh=3", "max_epochh"),
                                       ("--eval.vox_ress=64", "eval.vox_ress"),
                                       ("--data.synthetic.subsett=x", "data.synthetic.subsett")])
def test_an_unknown_override_raises_and_names_its_key_as_jax_does(typo, key, monkeypatch):
    monkeypatch.chdir(REPO)
    with pytest.raises(KeyError, match=re.escape(repr(key))):
        train.options([typo])
    with pytest.raises(KeyError, match=re.escape(repr(key))):
        train.options(["--yaml=options/shape_gen.yaml", typo])
    # the JAX CLI refuses the same key of the same recipe
    cli = jax_parse(["--yaml=options/shape_gen.yaml", typo])
    with pytest.raises(KeyError, match=re.escape(repr(key))):
        jax_set_options(cli, safe_check=True)
    # the evaluate CLI's options stay unchecked, as JAX evaluate.py:25
    assert train.options([typo], safe_check=False) is not None


@pytest.mark.parametrize("argv", [
    ["--task=shape", "--device=cpu", "--output_path=/tmp/x", "--load=a.ckpt", "--image_size=[64,64]", "--profile"],
    ["--task=depth", "--yaml=options/depth_gen.yaml", "--device=cpu", "--eval.depth_cap=3"],
    ["--yaml=options/shape_gen.yaml", "--eval.fused_decoder=interpret", "--optim.lr=5.e-3"],
])
def test_the_ports_own_keys_and_the_recipes_keys_pass(argv, monkeypatch):
    monkeypatch.chdir(REPO)
    opt = train.options(argv)
    assert opt.task == ("depth" if "--task=depth" in argv else "shape")
    assert "--task=shape" not in argv or (opt.device, opt.output_path, opt.H) == ("cpu", "/tmp/x", 64)
    assert "--optim.lr=5.e-3" not in argv or opt.optim.lr == 5e-3
    with pytest.raises(KeyError, match="'optim.lrr'"):  # the same options with one typo
        train.options(argv + ["--optim.lrr=5e-3"])


def _plain(opt):
    return yaml.safe_load(yaml.safe_dump(config._plain(opt.to_dict())))


WRITE = """
import sys
if sys.argv[1] == "blocked":
    sys.modules["yaml"] = None  # any import of it raises
from zeroshape_tpu_torch import config, train
opt = train.options(["--task=shape", "--optim.lr=3.e-05", "--seed=7", "--output_path=" + sys.argv[2]])
config.save_options_file(opt)
"""


@pytest.mark.parametrize("pyyaml", ["importable", "blocked"])
def test_options_file_reads_back_equal(pyyaml, tmp_path):
    out = tmp_path / "run"
    res = subprocess.run([sys.executable, "-c", WRITE, pyyaml, str(out)], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    got = yaml.safe_load(open(out / "options.yaml"))
    want = train.options(["--task=shape", "--optim.lr=3.e-05", "--seed=7", f"--output_path={out}"])
    assert got == _plain(want) and got["optim"]["lr"] == 3e-5 and got["eval"]["range"] == [-1.5, 1.5]
    assert isinstance(got["optim"]["weight_decay"], float) and got["pretrain"] == {"depth": None}


def test_train_writes_options_and_a_second_run_prints_the_jax_diff(tmp_path, monkeypatch, capsys):
    out = tmp_path / "run"
    seen = []

    class Engine:  # the engine's run is not what this test is about
        @staticmethod
        def train(opt, data, output_path, device=None):
            seen.append(os.path.isfile(os.path.join(output_path, "options.yaml")))
            return opt

    monkeypatch.setitem(train.ENGINES, "shape", Engine)
    first = train.main(["--task=shape", f"--output_path={out}", "--device=cpu"])
    assert seen == [True] and yaml.safe_load(open(out / "options.yaml")) == _plain(first)
    capsys.readouterr()
    second = train.main(["--task=shape", f"--output_path={out}", "--device=cpu", "--optim.lr=5.e-3", "--debug"])
    printed = capsys.readouterr().out.splitlines()
    want = jax_diff(_plain(first), _plain(second))
    assert want == ["  debug: False -> True", "  optim.lr: 0.0001 -> 0.005"]
    assert printed[printed.index("existing options file found (different from current one):") + 1:][:2] == want
    assert yaml.safe_load(open(out / "options.yaml")) == _plain(second)
    train.main(["--task=shape", f"--output_path={out}", "--device=cpu", "--optim.lr=5.e-3", "--debug"])
    assert "existing options file found (identical)" in capsys.readouterr().out


def test_seed_none_gives_a_four_letter_suffix_as_jax_does(monkeypatch):
    monkeypatch.chdir(REPO)
    opt = train.options(["--seed=null"])
    assert re.fullmatch(r"shape_gen_[A-Z]{4}", opt.name) and opt.output_path == os.path.join("output", "shape", opt.name)
    want = jax_process(JConfig({"name": "shape_gen", "seed": None}))["name"]
    assert re.fullmatch(r"shape_gen_[A-Z]{4}", want)
    assert train.options(["--seed=3"]).name == "shape_gen"
    assert train.options(["--seed=null"], safe_check=False).name == "shape_gen"  # the evaluate CLI's rule


@pytest.mark.parametrize("task, max_epoch", [("shape", 200), ("shape", 15), ("depth", 100), ("depth", 7)])
def test_freq_eval_default_is_jax_process_options(task, max_epoch):
    opt = train.options([f"--task={task}", "--freq.eval=null", f"--max_epoch={max_epoch}"])
    want = jax_process(JConfig({"name": "x", "seed": 0, "max_epoch": max_epoch, "freq": {"eval": None}}))
    assert opt.freq.eval == want["freq"]["eval"] == max(max_epoch // 20, 1)
    assert train.options([f"--task={task}"]).freq.eval == (50 if task == "shape" else 25)
