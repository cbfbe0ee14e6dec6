"""Profiling and running statistics (port of fenerf_tpu/utils/profiling.py).

- `trace(dir)`: a context manager around torch.profiler (CPU and, where
  present, CUDA activity) that writes a Chrome trace into `dir`.
- `StatsCollector`: running mean / std / min / max per metric, the
  counterpart of the reference's vendored-but-unused training_stats
  (siren/torch_utils/training_stats.py).
"""
from __future__ import annotations

import contextlib
import json
import math
import os
from collections import defaultdict


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; writes <log_dir>/trace.json (chrome://tracing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StatsCollector:
    def __init__(self):
        self._n = defaultdict(int)
        self._sum = defaultdict(float)
        self._sumsq = defaultdict(float)
        self._min = {}
        self._max = {}

    def report(self, **metrics: float) -> None:
        for k, v in metrics.items():
            v = float(v)
            self._n[k] += 1
            self._sum[k] += v
            self._sumsq[k] += v * v
            self._min[k] = min(self._min.get(k, v), v)
            self._max[k] = max(self._max.get(k, v), v)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for k, n in self._n.items():
            mean = self._sum[k] / n
            var = max(self._sumsq[k] / n - mean * mean, 0.0)
            out[k] = {"n": n, "mean": mean, "std": math.sqrt(var),
                      "min": self._min[k], "max": self._max[k]}
        return out

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=1)
