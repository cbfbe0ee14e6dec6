"""Nothing the benchmark runs loads JAX or the JAX package (compared by
whole top-level names: the port, fenerf_tpu_torch, is not fenerf_tpu), and
the reference imports nothing of the program."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import importcheck, registry

FORBIDDEN = {"jax", "jaxlib", "flax", "fenerf_tpu"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
    return out


def _sources(*folders):
    for f in folders:
        yield from sorted((registry.ROOT / f).rglob("*.py"))


def test_top_level_names_compared_whole():
    assert importcheck.forbidden(["fenerf_tpu_torch", "fenerf_tpu_torch.ops",
                                  "numpy", "jaxtyping"]) == []
    assert importcheck.forbidden(["fenerf_tpu.nn.fields", "jax.numpy",
                                  "flax.linen", "jaxlib"]) == [
        "fenerf_tpu", "flax", "jax", "jaxlib"]


def test_no_source_of_the_benchmark_names_jax():
    for path in _sources("harness", "drivers", "metrics", "reference",
                         "configs"):
        tops = {importcheck.top_level(m) for m in _imports(path)}
        assert not tops & FORBIDDEN, path
    assert not {importcheck.top_level(m)
                for m in _imports(registry.ROOT / "run.py")} & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "contextlib", "math", "struct", "typing",
               "zlib", "numpy", "torch", "benchmark"}
    for path in _sources("reference"):
        for m in _imports(path):
            assert importcheck.top_level(m) in allowed, (path, m)
            if m.startswith("benchmark"):
                assert m.startswith("benchmark.reference"), (path, m)


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "from benchmark.harness import registry, importcheck;"
            "[registry.load_module(p) for p in "
            "sorted(registry.ROOT.glob('drivers/*.py'))];"
            "registry.metric_readers();"
            "import fenerf_tpu_torch.train.loop, "
            "fenerf_tpu_torch.apps.render_video;"
            "print(importcheck.forbidden(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_or_the_program_no_result(tmp_path):
    """run.py without CUDA, and in a directory that holds only
    BENCHMARK.json and benchmark/, exits non-zero and prints nothing on
    standard output."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    args = ["benchmark/run.py", "--workload", "film-render-128", "--seed",
            str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"]
    out = subprocess.run([sys.executable] + args, cwd=registry.REPO,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    shutil.copytree(registry.ROOT, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if (registry.REPO / "BENCHMARK.json").exists():
        shutil.copy(registry.REPO / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable] + args, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("cell", ["film-render-128", "grid-video-128",
                                  "film-train-128"])
def test_cell_files_name_one_chip_and_a_reason(cell):
    w = registry.workload(cell)
    assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
    assert set(w["limits"]) and all(v > 0 for v in w["limits"].values())
    json.dumps(w)
