"""What the span readers share: the program's span table for the traced
window (fenerf_tpu_torch/utils/profiling.py::span_totals: calls, device ms
from each span's entry event to its exit event, self device ms, summed
counts, by span name) and the device's idle time under one program span
on the profiler's timeline.

A program without spans (no span_totals, or none recorded) reads None,
and so does every metric read from it.
"""
from __future__ import annotations

from benchmark.harness import trace

PREFIX = "fenerf/"


def table(run) -> dict | None:
    """span_totals() of the program, read once per run (it synchronizes the
    device); None where the program has no spans."""
    if "span_totals" not in run.facts:
        try:
            from fenerf_tpu_torch.utils import profiling
        except ImportError:
            profiling = None
        read = getattr(profiling, "span_totals", None)
        run.facts["span_totals"] = read() if read is not None else None
    return run.facts["span_totals"] or None


def summed(run, names, key: str = "device_ms") -> float | None:
    """The sum of `key` over the spans `names` that ran; None where none of
    them ran or none has a reading for `key`."""
    t = table(run)
    if t is None:
        return None
    vals = [t[n][key] for n in names if n in t and t[n][key] is not None]
    return sum(vals) if vals else None


def innermost(tl: trace.Timeline) -> list:
    """[(name, start, end)]: the pieces of the window in which some program
    span (host, name starting PREFIX) is open, each with the innermost one
    (the latest started; of two started together, the one that ends
    first)."""
    spans = trace.clip([h for h in tl.host if h[0].startswith(PREFIX)],
                       tl.start, tl.end)
    cuts = sorted({t for _, s, e in spans for t in (s, e)})
    pieces = []
    for a, b in zip(cuts, cuts[1:]):
        cover = [(s, -e, n) for n, s, e in spans if s <= a and e >= b]
        if cover:
            pieces.append((max(cover)[2], a, b))
    return pieces


def idle_gaps(tl: trace.Timeline) -> list:
    """[(start, end)] of the window with no device operation running."""
    gaps, at = [], tl.start
    for s, e in trace.union(trace.clip(tl.device, tl.start, tl.end)):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if tl.end > at:
        gaps.append((at, tl.end))
    return gaps


def idle_share_under(tl: trace.Timeline, name: str) -> float | None:
    """Share of the window, in %, with no device operation running while
    the innermost open program span was `name` itself (whole gaps, not only
    where they start); None where `name` never ran in the window."""
    pieces = [(s, e) for n, s, e in innermost(tl) if n == name]
    if not pieces:
        return None
    gaps = idle_gaps(tl)
    idle, i = 0.0, 0
    for s, e in pieces:                  # both lists sorted and disjoint
        while i < len(gaps) and gaps[i][1] <= s:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < e:
            idle += min(e, gaps[j][1]) - max(s, gaps[j][0])
            j += 1
    return 100.0 * idle / (tl.end - tl.start)
