"""The measurement path raises without a card and prints no result."""

import subprocess
import sys

import pytest
import torch

from zsbench import manifest, run


def test_run_exits_non_zero_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = subprocess.run([sys.executable, "-m", "zsbench.run", "--workload", "zeroshape.recon_b8", "--seed",
                          str(2**31 + 11), "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         cwd=manifest.ROOT, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                                                  "TMPDIR": str(tmp_path)})
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA card" in res.stderr


def test_require_cards_counts_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    run.require_cards(1)
    with pytest.raises(SystemExit):
        run.require_cards(4)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "zeroshape_tpu_torch_like", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


def test_the_result_line_is_strict_json():
    line = run.finite({"compared": {"loss_gap": {"value": float("inf"), "limit": 0.003}}, "x": [float("nan"), 1.0]})
    assert line == {"compared": {"loss_gap": {"value": None, "limit": 0.003}}, "x": [None, 1.0]}
