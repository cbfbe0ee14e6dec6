"""Profiling, program spans and running statistics (port of
fenerf_tpu/utils/profiling.py, with the spans the port adds).

- `trace(dir)`: a context manager around torch.profiler (CPU and, where
  present, CUDA activity) that writes a Chrome trace into `dir` and the
  table of the program's spans beside it.
- `span(name, **counts)`: a named stretch of the program. With no torch
  profiler running it is one flag check and a shared no-op context; under
  a profiler it is a `record_function` range (drawn on the profiler's own
  clock, over the device work it launched) and, on CUDA, a pair of timing
  events on the current stream, kept in memory with the counts passed in
  (e.g. `rows=`). `span_totals()` sums the kept spans by name;
  `reset_spans()` drops them.
- `StatsCollector`: running mean / std / min / max per metric, the
  counterpart of the reference's vendored-but-unused training_stats
  (siren/torch_utils/training_stats.py).
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time
from collections import defaultdict

import torch
from torch.autograd.profiler import record_function

# whether a profiler records this thread's record_function ranges
_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_SPANS: list = []                # SpanRecord of every closed span
_LOCAL = threading.local()       # .stack: the thread's open spans


class SpanRecord:
    """One span, and the context that records it: its name, the span it ran
    inside (None at the top), host start and end (time.perf_counter
    seconds), its CUDA event pair (None off CUDA), the counts passed in, and
    device_ms once span_totals has read the events."""
    __slots__ = ("name", "parent", "host_start", "host_end", "events",
                 "counts", "device_ms", "_range")

    def __init__(self, name: str, parent, counts: dict):
        self.name, self.parent, self.counts = name, parent, counts
        self.host_start = self.host_end = 0.0
        self.events = self.device_ms = self._range = None

    def __enter__(self) -> SpanRecord:
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self._range = record_function(self.name)
        self._range.__enter__()
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.host_start = time.perf_counter()
        stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        self.host_end = time.perf_counter()
        if self.events is not None:
            self.events[1].record()
        _stack().pop()
        self._range.__exit__(*exc)
        self._range = None
        _SPANS.append(self)
        return False


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def span(name: str, **counts):
    """A context for one stretch of the program named `name` ("fenerf/..."),
    recorded only while a torch profiler records this thread; counts (ints)
    are summed per name by span_totals."""
    if not _profiler_enabled():
        return _OFF
    return SpanRecord(name, None, counts)


def reset_spans() -> None:
    """Drops every kept span."""
    _SPANS.clear()


def span_totals() -> dict[str, dict]:
    """Per span name: calls, host_ms, device_ms (the stream's time from the
    entry event to the exit event, idle inside the span included),
    self_device_ms (device_ms less that of the spans directly inside) and
    counts (summed); device_ms and self_device_ms are None for spans that
    ran without CUDA. Synchronizes the device first."""
    records = list(_SPANS)
    if any(r.events is not None for r in records):
        torch.cuda.synchronize()
        for r in records:
            if r.events is not None and r.device_ms is None:
                r.device_ms = r.events[0].elapsed_time(r.events[1])
    return totals(records)


def totals(records) -> dict[str, dict]:
    """span_totals' arithmetic over SpanRecords whose device_ms is set."""
    inner = defaultdict(float)       # id(record) -> children's device ms
    kept = {id(r) for r in records}
    for r in records:
        if r.parent is not None and id(r.parent) in kept \
                and r.device_ms is not None:
            inner[id(r.parent)] += r.device_ms
    out: dict[str, dict] = {}
    for r in records:
        t = out.setdefault(r.name, {"calls": 0, "host_ms": 0.0,
                                    "device_ms": None,
                                    "self_device_ms": None, "counts": {}})
        t["calls"] += 1
        t["host_ms"] += 1e3 * (r.host_end - r.host_start)
        if r.device_ms is not None:
            t["device_ms"] = (t["device_ms"] or 0.0) + r.device_ms
            t["self_device_ms"] = ((t["self_device_ms"] or 0.0)
                                   + r.device_ms - inner[id(r)])
        for k, v in r.counts.items():
            t["counts"][k] = t["counts"].get(k, 0) + v
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; writes <log_dir>/trace.json (chrome://tracing)
    and <log_dir>/spans.json (span_totals of the block's spans)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset_spans()
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(span_totals(), f, indent=1)


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
