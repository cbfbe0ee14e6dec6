"""On the card: each cell of BENCHMARK.json runs once through
benchmark/run.py with a short window and comes out correct (skips without
a CUDA device; the fixture decides, never an import).

  python -m pytest benchmark/tests/test_bench_card.py -q -p no:cacheprovider
"""
import json
import subprocess
import sys

import pytest

from benchmark.harness import registry

BENCH = json.loads((registry.REPO / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct_on_the_card(cuda_device, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 101), "--seconds", "3", "--trace", "0"],
        cwd=registry.REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "gpu"
