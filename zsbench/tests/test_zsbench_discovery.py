"""A configuration, a traffic mix, a cell's limits and a per-layer metric are
found by name from new files, with no edit of an existing one."""

import json

from zsbench import manifest


def test_new_files_are_found_by_name(tmp_path):
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "limits").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "configs" / "other.json").write_text(json.dumps({"name": "other", "options": {"H": 224}}))
    (tmp_path / "traffic" / "burst.json").write_text(json.dumps({"runner": "recon", "batch": 4}))
    (tmp_path / "limits" / "other.burst.json").write_text(json.dumps({"depth_gap": 0.1}))
    (tmp_path / "metrics" / "new_ms.recon.py").write_text("def value(ctx):\n    return 2.0 * ctx['x']\n")
    bench = {"configs": [{"name": "other", "file": "configs/other.json"}],
             "workloads": [{"name": "other.burst", "config": "other", "traffic": "burst", "chips": 1}],
             "end_to_end": [{"name": "recon_img_per_s"}, {"name": "setup_s"}],
             "per_layer": [{"name": "new_ms.recon", "moves": "recon_img_per_s"}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    b = manifest.load(tmp_path)
    cell = manifest.cell(b, "other.burst")
    assert manifest.config(b, cell["config"], tmp_path)["name"] == "other"
    assert manifest.traffic(cell["traffic"], tmp_path)["batch"] == 4
    assert manifest.limits("other.burst", tmp_path) == {"depth_gap": 0.1}
    assert manifest.reader("new_ms.recon", tmp_path).value({"x": 3.0}) == 6.0
    # a metric without a list is reported by every cell that reports what it moves
    assert [m["name"] for m in manifest.per_layer(b, "other.burst")] == ["new_ms.recon"]
    assert manifest.runner(manifest.traffic("burst", tmp_path)["runner"]).Runner


def test_every_shipped_mix_names_a_runner_module():
    for path in sorted((manifest.HERE / "traffic").glob("*.json")):
        assert manifest.runner(json.loads(path.read_text())["runner"]).Runner
