"""The span readers' arithmetic: a stubbed span table of the program
(utils/profiling.py::span_totals) and a synthetic profiler timeline whose
host list holds the program's fenerf/ spans."""
import pytest

from benchmark.harness import registry, spans, trace
from benchmark.tests import tiny

READERS = registry.metric_readers()
NEW = ("d_phase_ms.train", "g_phase_ms.train", "field_ms.render",
       "ray_ms.render", "field_rows_per_call.render", "ray_idle.render",
       "ray_idle.train")


class _Run:
    def __init__(self, kind, timeline=None, **facts):
        self.facts = {"kind": kind, **facts}
        self.timeline = timeline


def _entry(calls, device_ms, self_ms=None, **counts):
    return {"calls": calls, "host_ms": 1.0, "device_ms": device_ms,
            "self_device_ms": device_ms if self_ms is None else self_ms,
            "counts": counts}


@pytest.fixture
def table(monkeypatch):
    """Sets what the program's span_totals() returns."""
    from fenerf_tpu_torch.utils import profiling

    def put(t):
        monkeypatch.setattr(profiling, "span_totals", lambda: t)
    return put


def test_train_phases_per_step(table):
    table({"fenerf/train/d_img": _entry(2, 300.0),
           "fenerf/train/d_seg": _entry(2, 200.0),
           "fenerf/train/g": _entry(2, 1000.0, 400.0),
           "fenerf/render": _entry(12, 700.0)})
    run = _Run("train", steps=2)
    assert READERS["d_phase_ms.train"].read(run) == pytest.approx(250.0)
    assert READERS["g_phase_ms.train"].read(run) == pytest.approx(500.0)
    # an RGB-only model has no D_seg phase
    table({"fenerf/train/d_img": _entry(2, 300.0),
           "fenerf/train/g": _entry(2, 1000.0)})
    assert READERS["d_phase_ms.train"].read(_Run("train", steps=2)) == \
        pytest.approx(150.0)


def test_render_field_and_ray_per_image(table):
    table({"fenerf/render": _entry(3, 90.0, 30.0),
           "fenerf/render/field": _entry(24, 60.0, rows=24 * 98_304)})
    run = _Run("render", images=48)
    assert READERS["field_ms.render"].read(run) == pytest.approx(1.25)
    assert READERS["ray_ms.render"].read(run) == pytest.approx(0.625)
    assert READERS["field_rows_per_call.render"].read(run) == 98_304
    # the table is read once per run (span_totals synchronizes)
    table(None)
    assert READERS["ray_ms.render"].read(run) == pytest.approx(0.625)


def test_none_where_nothing_to_read(table, monkeypatch):
    from fenerf_tpu_torch.utils import profiling

    table({"fenerf/render": _entry(3, 90.0, 30.0),
           "fenerf/render/field": _entry(24, 60.0, rows=100),
           "fenerf/train/d_img": _entry(2, 300.0),
           "fenerf/train/g": _entry(2, 1000.0)})
    # the other kind of cell
    for name in ("d_phase_ms.train", "g_phase_ms.train", "ray_idle.train"):
        assert READERS[name].read(_Run("render", images=4)) is None
    for name in ("field_ms.render", "ray_ms.render",
                 "field_rows_per_call.render", "ray_idle.render"):
        assert READERS[name].read(_Run("train", steps=2)) is None
    # spans that ran without CUDA have no device time; no rows counted
    table({"fenerf/render": _entry(3, None),
           "fenerf/render/field": _entry(24, None),
           "fenerf/train/g": _entry(2, None)})
    assert READERS["field_ms.render"].read(_Run("render", images=4)) is None
    assert READERS["ray_ms.render"].read(_Run("render", images=4)) is None
    assert READERS["g_phase_ms.train"].read(_Run("train", steps=2)) is None
    assert READERS["field_rows_per_call.render"].read(
        _Run("render", images=4)) is None
    # no span recorded
    table({})
    for name in NEW:
        kind = "train" if name.endswith(".train") else "render"
        assert READERS[name].read(_Run(kind, _timeline(host=[]), steps=2,
                                       images=4)) is None, name
    # a program without spans (the parent of this benchmark's spans)
    monkeypatch.delattr(profiling, "span_totals")
    for name in NEW:
        kind = "train" if name.endswith(".train") else "render"
        assert READERS[name].read(_Run(kind, _timeline(host=[]), steps=2,
                                       images=4)) is None, name


def _timeline(host=None, phase=None):
    """Window 0-1000 us; device ops 100-150, 250-350, 500-550, 850-950;
    a render 100-900 with field calls 200-400 and 600-700."""
    device = [("k", 100.0, 150.0), ("k", 250.0, 350.0),
              ("k", 500.0, 550.0), ("k", 850.0, 950.0)]
    if host is None:
        host = [("bench/window", 0.0, 1000.0),
                ("fenerf/render", 100.0, 900.0),
                ("fenerf/render/field", 200.0, 400.0),
                ("aten::mm", 210.0, 390.0),
                ("fenerf/render/field", 600.0, 700.0)]
    if phase is not None:
        host = host + [phase]
    return trace.Timeline(device, host, 0.0, 1000.0)


def test_innermost_span_pieces():
    pieces = spans.innermost(_timeline(phase=("fenerf/train/g", 100.0,
                                              950.0)))
    # the phase starts with the render: the render, which ends first, is
    # the inner one
    assert pieces == [("fenerf/render", 100.0, 200.0),
                      ("fenerf/render/field", 200.0, 400.0),
                      ("fenerf/render", 400.0, 600.0),
                      ("fenerf/render/field", 600.0, 700.0),
                      ("fenerf/render", 700.0, 900.0),
                      ("fenerf/train/g", 900.0, 950.0)]


def test_ray_idle_counts_gaps_in_the_render_outside_field_calls():
    # gaps 0-100 (no span), 150-250 (render to 200, then a field call),
    # 350-500 (field to 400, render after), 550-850 (render, a field call
    # 600-700, render again), 950-1000 (no span): 50 + 100 + 200 us
    tl = _timeline()
    assert spans.idle_share_under(tl, "fenerf/render") == pytest.approx(35.0)
    assert spans.idle_share_under(tl, "fenerf/render/field") == \
        pytest.approx(20.0)
    assert READERS["ray_idle.render"].read(_Run("render", tl)) == \
        pytest.approx(35.0)
    # in a training step the phase's own idle is not the render's
    tl = _timeline(phase=("fenerf/train/g", 0.0, 1000.0))
    assert READERS["ray_idle.train"].read(_Run("train", tl)) == \
        pytest.approx(35.0)
    assert spans.idle_share_under(tl, "fenerf/train/g") == \
        pytest.approx(15.0)


def test_new_metrics_listed_with_their_cells():
    import json

    bench = json.loads((registry.REPO / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert READERS[name].UNIT == m["unit"]
        kind = "train" if name.endswith(".train") else "render"
        cells = ["film-train-128"] if kind == "train" else [
            "film-render-128", "grid-video-128"]
        assert m["workloads"] == cells
        assert m["source"] == ("device_trace" if "idle" in name
                               else "program_counter")


def test_traced_tiny_render_counts_its_field_rows():
    """The film render cell at tiny sizes, traced on the CPU: the program's
    spans reach the readers (no device time here, so only the counts and
    the timeline's shares read)."""
    from fenerf_tpu_torch.utils import profiling

    profiling.reset_spans()
    run = tiny.tiny_run("film-render-128", trace=True)
    res = tiny.execute(run)
    t = run.traffic
    rows = t["batch"] * t["ray_chunk"] * t["num_steps"]
    got = res["metrics"]
    assert got["field_rows_per_call.render"]["value"] == rows
    assert 0.0 <= got["ray_idle.render"]["value"] <= 100.0
    assert "ray_ms.render" not in got and "field_ms.render" not in got
    assert not any(n.startswith("fenerf/")
                   for n, _ in res["breakdown"]["device_ops"])
    profiling.reset_spans()
