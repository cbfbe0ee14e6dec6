"""One run of one cell: set-up, the measured window, the per-layer readers
on a traced run, the check against the plain reference, and the result.

A driver (drivers/<name>.py) provides
  setup(run)           build, make weights and inputs from the seed, warm up
  window(run, seconds) the measured work; returns the cell's end-to-end
                       metrics other than setup_s ({name: value})
  release(run)         drop the program's state
  check(run)           [Check] from the reference, after release
and records what readers need in run.facts.
"""
from __future__ import annotations

import contextlib
import math
import os
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

from benchmark.harness import registry, trace
from benchmark.reference import precision

UNITS = {"train_img_per_s": "img/s", "render_img_per_s": "img/s",
         "setup_s": "s"}


class Check(NamedTuple):
    """One number compared with the reference and its limit (pass when
    value <= limit)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


class Run:
    """Everything one run of a cell knows; drivers and readers share it."""

    def __init__(self, workload: str, seed: int, seconds: float,
                 trace_on: bool, device, root: Path = registry.ROOT,
                 overrides: dict | None = None):
        self.cell = registry.workload(workload, root)
        self.config = registry.config(self.cell["config"], root)
        self.traffic = registry.traffic(self.cell["traffic"], root)
        if overrides:
            self.config = {**self.config, **overrides.get("config", {})}
            self.traffic = {**self.traffic, **overrides.get("traffic", {})}
        self.flops = registry.flops(self.config)
        self.peaks = registry.device_peaks(root)
        self.driver = registry.driver(self.traffic["driver"], root)
        # the reference computes each product in the precision the
        # configuration states for it (float32 with TF32 off, or bf16
        # operands with float32 sums)
        self.reference = precision.configured(self.config)
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace_on)
        self.device = device
        self.state: dict = {}       # the driver's program state
        self.facts: dict = {}       # what the readers read
        self.attempted = 0
        self.failed = 0
        self.timeline = None

    def inputs_generator(self, *tags):
        """A torch.Generator on the run's device for (seed, *tags): the same
        seed and tags give the same draws."""
        import torch

        key = self.seed % (2 ** 63)
        for t in tags:
            key = (key * 1_000_003 + int(t)) % (2 ** 63)
        return torch.Generator(device=self.device).manual_seed(key)


def process_seconds() -> float:
    """Seconds since this process started (boot clock against the
    process's start tick in /proc)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _IMPORTED


_IMPORTED = time.monotonic()


def _synchronize(run: Run) -> None:
    import torch

    if torch.device(run.device).type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def phase(run: Run, name: str):
    """Times one stretch of set-up, to its device work's end, into
    run.facts["setup_phases"] (printed on standard error)."""
    t0 = time.monotonic()
    try:
        yield
    finally:
        _synchronize(run)
        run.facts.setdefault("setup_phases", {})[name] = \
            time.monotonic() - t0


def note(run: Run, text: str) -> None:
    """A line for standard error, printed before the checks."""
    run.facts.setdefault("notes", []).append(text)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def execute(run: Run, process_t0: float) -> dict:
    """Set-up, window, readers, check. Returns the result dict (without
    the import check, which the caller makes once the window has closed)."""
    import torch

    cuda = torch.device(run.device).type == "cuda"
    run.facts["setup_phases"] = {
        "process start to set-up": time.monotonic() - process_t0}
    run.driver.setup(run)
    if cuda:
        torch.cuda.synchronize()
        run.facts["setup_peak_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.monotonic() - process_t0
    sink: dict = {}
    with trace.profiled(run.trace, sink):
        e2e = run.driver.window(run, run.seconds)
    run.timeline = sink.get("timeline")
    peak = 0
    if cuda:
        torch.cuda.synchronize()
        run.facts["window_peak_bytes"] = torch.cuda.max_memory_allocated()
        peak = max(run.facts["setup_peak_bytes"],
                   run.facts["window_peak_bytes"])
    metrics = {}
    breakdown = None
    if run.trace:
        for name, reader in registry.metric_readers().items():
            value = reader.read(run)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": reader.UNIT}
        tl = run.timeline
        breakdown = {"device_ops": trace.top_device_ops(tl),
                     "idle_gaps": trace.idle_gaps(tl)}
    else:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        for name, value in e2e.items():
            metrics[name] = {"value": float(value), "unit": UNITS[name]}
    run.driver.release(run)
    run.state.clear()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    checks = run.driver.check(run)
    run.facts["check_s"] = time.monotonic() - t_check
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name() if cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(peak),
              "power": power_limit() if cuda else "none"}
    if run.trace:
        device["busy_s"] = trace.busy_s(run.timeline)
        device["window_s"] = run.timeline.window_s
    result = {"correct": bool(checks) and all(c.ok for c in checks),
              "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result
