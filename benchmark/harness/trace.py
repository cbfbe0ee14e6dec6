"""The traced run's timeline: torch.profiler's device operations and host
ops over the harness's window span, and the arithmetic the per-layer
readers share (the union of device intervals, idle gaps, time by name).

Times are microseconds on the profiler's clock. `Timeline.device` holds
(name, start, end) of every operation that ran on the device (kernels,
copies, sets); `Timeline.host` the host ops and the harness's own
record_function spans (names starting "bench/").
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

WINDOW_SPAN = "bench/window"


class Timeline(NamedTuple):
    device: list          # [(name, start_us, end_us)]
    host: list            # [(name, start_us, end_us)]
    start: float          # the window span's bounds
    end: float

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6


def clip(intervals, lo, hi):
    return [(n, max(s, lo), min(e, hi)) for n, s, e in intervals
            if e > lo and s < hi]


def union(intervals) -> list:
    """Merged [(start, end)] of (name, start, end) intervals: overlapping
    operations count once."""
    merged = []
    for _, s, e in sorted(intervals, key=lambda t: t[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def busy_s(tl: Timeline) -> float:
    return sum(e - s for s, e in union(clip(tl.device, tl.start, tl.end))
               ) / 1e6


def idle_share(tl: Timeline) -> float:
    """Share of the window that no device operation covers, in %."""
    return 100.0 * (1.0 - busy_s(tl) / tl.window_s)


def top_device_ops(tl: Timeline, k: int = 10) -> list:
    """[[name, seconds]] of the k names that took the most device time."""
    by = {}
    for n, s, e in clip(tl.device, tl.start, tl.end):
        by[n] = by.get(n, 0.0) + (e - s) / 1e6
    return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(tl: Timeline, k: int = 10) -> list:
    """[[host op in flight, seconds]] of the k longest stretches of the
    window with nothing on the device, each named by the innermost host op
    (latest started) that covers the gap's start."""
    busy = union(clip(tl.device, tl.start, tl.end))
    gaps, at = [], tl.start
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if tl.end > at:
        gaps.append((at, tl.end))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:k]
    out = []
    for s, e in gaps:
        inner = [(hs, n) for n, hs, he in tl.host
                 if hs <= s < he and n != WINDOW_SPAN]
        label = max(inner)[1] if inner else "none"
        out.append([label, (e - s) / 1e6])
    return out


@contextlib.contextmanager
def profiled(enabled: bool, sink: dict):
    """Profile the block (CPU and CUDA activities) when `enabled`, inside
    a WINDOW_SPAN record_function; on exit put the Timeline in
    sink["timeline"]."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    if not enabled:
        yield
        return
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            yield
        if cuda:
            torch.cuda.synchronize()
    device, host, window = [], [], None
    for ev in prof.events():
        tr = ev.time_range
        item = (ev.name, float(tr.start), float(tr.end))
        if ev.device_type == DeviceType.CUDA:
            # a record_function range is also drawn on the device's
            # timeline: only operations count
            if not getattr(ev, "is_user_annotation", False) \
                    and not ev.name.startswith("bench/"):
                device.append(item)
        else:
            host.append(item)
            if ev.name == WINDOW_SPAN:
                window = item
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    sink["timeline"] = Timeline(device, host, window[1], window[2])
