"""The benchmark of fenerf_tpu_torch: one run of one cell on one GPU.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                           --trace <0|1>

Set-up (kernel builds into the checkout's build/, weights and inputs made
on the device from --seed, a warm-up of the cell's shapes), then --seconds
of measured work, then the check of what the timed path produced against
the plain reference (benchmark/reference/). The last line of standard
output is one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics with --trace 0, its per-layer metrics read from a
profiled stretch with --trace 1), device and, traced, breakdown; its last
key, checks, gives each number compared with its limit, as do the last
lines of standard error. Exits non-zero, printing no result, without a
CUDA device or if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BUILD = REPO / "build"
# every cache of the program and its libraries stays in the checkout: the
# kernels' and, for the modules that torch imports lazily on the first
# render or step, Python's compiled bytecode
sys.pycache_prefix = str(BUILD / "pycache")
sys.dont_write_bytecode = False
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(BUILD / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark.harness import core, importcheck  # noqa: E402

PROCESS_T0 = time.monotonic() - core.process_seconds()


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    run = core.Run(args.workload, args.seed, args.seconds, bool(args.trace),
                   device="cuda")
    chips = int(run.cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = core.execute(run, PROCESS_T0)
    found = importcheck.forbidden(sys.modules)
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    phases = ", ".join(f"{k} {v:.3f} s"
                       for k, v in run.facts["setup_phases"].items())
    print(f"set-up phases: {phases}", file=sys.stderr)
    for line in run.facts.get("notes", ()):
        print(line, file=sys.stderr)
    print(f"reference check took {run.facts['check_s']:.1f} s",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
