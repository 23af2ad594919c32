"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import json
import re

import pytest

from zsbench import manifest

BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_command_and_paths():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "-m", "zsbench.run"]
    assert BENCH["paths"] == ["zsbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names), names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert LINE.match(entry["why"])
    for m in BENCH["per_layer"]:
        assert LINE.match(m["layer"])


def test_entries_have_only_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert not c["reduced"] and c["file"].startswith("zsbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in manifest.end_to_end(BENCH, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = manifest.per_layer(BENCH, w["name"])
        assert layer
        for m in layer:  # each per-layer metric moves an end-to-end metric the cell reports
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_one_layer_name_per_layer_and_moves_names_an_end_to_end_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        if m["name"].startswith("device_idle_pct"):
            assert m["layer"] == "device"


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_files_of_each_cell_exist(w):
    cfg = manifest.config(BENCH, w["config"])
    assert cfg["name"] == w["config"] and cfg["reduced"] == []
    mix = manifest.traffic(w["traffic"])
    assert (manifest.HERE / "runners" / f"{mix['runner']}.py").is_file()
    assert manifest.limits(w["name"])
    for m in manifest.per_layer(BENCH, w["name"]):
        assert hasattr(manifest.reader(m["name"]), "value")


def test_configuration_files_hold_the_port_presets():
    from zsbench import program  # imports the port, never the JAX package

    for c in BENCH["configs"]:
        cfg = json.loads((manifest.ROOT / c["file"]).read_text())
        opt = program.options(cfg["options"])  # every key must exist in config.full_opt
        assert opt.arch.impl.n_channels == 256 and opt.H == 224
