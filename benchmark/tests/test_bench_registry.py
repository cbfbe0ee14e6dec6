"""Every piece is found by its name; adding one adds files and edits none;
BENCHMARK.json agrees with the files."""
import json
import shutil
from pathlib import Path

import pytest

from benchmark.harness import registry
from benchmark.tests import tiny

BENCH = json.loads((registry.REPO / "BENCHMARK.json").read_text()) \
    if (registry.REPO / "BENCHMARK.json").exists() else None


def _copy(tmp_path) -> Path:
    root = tmp_path / "benchmark"
    shutil.copytree(registry.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root


def test_new_cell_config_traffic_found_by_name(tmp_path):
    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs/film-dim96.json").read_text())
    (root / "configs/film-copy.json").write_text(
        json.dumps({**cfg, "name": "film-copy"}))
    tr = json.loads((root / "traffic/fid-batch16-128.json").read_text())
    (root / "traffic/fid-batch8-128.json").write_text(
        json.dumps({**tr, "batch": 8}))
    cell = json.loads((root / "workloads/film-render-128.json").read_text())
    (root / "workloads/film-copy-render-8.json").write_text(json.dumps(
        {**cell, "config": "film-copy", "traffic": "fid-batch8-128"}))
    run = tiny.core.Run("film-copy-render-8", 3, 0.1, False, "cpu",
                        root=root)
    assert run.config["name"] == "film-copy"
    assert run.traffic["batch"] == 8
    assert run.driver.__name__.endswith("drivers_batch_render_py")
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_new_metric_reader_found_without_edits(tmp_path):
    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "metrics/frames_seen.render.py").write_text(
        "UNIT = 'img'\n\ndef read(run):\n"
        "    return run.facts.get('images')\n")
    readers = registry.metric_readers(root)
    assert "frames_seen.render" in readers
    assert set(registry.metric_readers()) <= set(readers)

    class _Run:
        facts = {"images": 12}

    assert readers["frames_seen.render"].read(_Run()) == 12
    assert {p: p.read_bytes() for p in before} == before


def test_unknown_names_say_what_there_is():
    with pytest.raises(KeyError, match="film-render-128"):
        registry.workload("no-such-cell")


@pytest.mark.skipif(BENCH is None, reason="no BENCHMARK.json")
def test_benchmark_json_matches_the_files():
    readers = registry.metric_readers()
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        data = json.loads((registry.REPO / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        cell = registry.workload(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) \
            == (w["config"], w["traffic"], w["chips"], w["why"])
        assert w["config"] in configs
        registry.traffic(w["traffic"])
    for m in BENCH["per_layer"]:
        assert m["name"] in readers, m["name"]
        assert readers[m["name"]].UNIT == m["unit"]
        assert m["moves"] in e2e
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]


@pytest.mark.skipif(BENCH is None, reason="no BENCHMARK.json")
def test_run_seconds_fit_the_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
