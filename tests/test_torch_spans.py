"""The port's program spans (utils/profiling.py::span): free when no
profiler runs, named and counted under one, nested as the program nests,
and without effect on what the program computes. CPU, tiny sizes."""
import dataclasses
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fenerf_tpu_torch.compat.jax_bridge import tree_leaves
from fenerf_tpu_torch.models import generator as tgen
from fenerf_tpu_torch.train import curriculum as tcur
from fenerf_tpu_torch.train import loop as tloop
from fenerf_tpu_torch.train import sharding
from fenerf_tpu_torch.utils import profiling

torch.set_num_threads(2)

TINY = dict(batch_size=4, batch_split=2, img_size=8, num_steps=4,
            latent_geo_dim=8, latent_app_dim=8,
            field_overrides=(("hidden_dim", 16), ("map_hidden_dim", 16),
                             ("grid_resolution", 8), ("grid_channels", 8)))
# 8 x 8 rays in blocks of 16: 4 blocks, a coarse and a fine field call each
RCFG = tgen.RenderConfig(img_size=8, num_steps=4, ray_chunk=16)


def _field(pts, drs):
    return torch.cat([torch.sin(pts), pts.norm(dim=-1, keepdim=True)], -1)


def _render(batch=2):
    return tgen.render_core(_field, 4, RCFG, batch,
                            generator=torch.Generator().manual_seed(3))


@pytest.fixture
def spans():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _profiled(fn, names=True):
    """fn() under a CPU profiler, and the names of the profiler's events
    (parsing them takes seconds after a training step: names=False)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, {e.name for e in prof.events()} if names else None


def test_no_profiler_no_record(spans, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert profiling.span("fenerf/a", rows=3) is profiling.span("fenerf/b")
    with profiling.span("fenerf/a", rows=3):
        pass
    _render()
    assert profiling.span_totals() == {}


def test_render_spans_count_blocks_and_rows(spans):
    _, names = _profiled(_render)
    assert {"fenerf/render", "fenerf/render/field"} <= names
    t = profiling.span_totals()
    assert set(t) == {"fenerf/render", "fenerf/render/field"}
    assert t["fenerf/render"]["calls"] == 1
    assert t["fenerf/render/field"]["calls"] == 2 * 64 // 16
    assert t["fenerf/render/field"]["counts"] == {"rows": 2 * 64 * 4 * 2}
    assert t["fenerf/render"]["device_ms"] is None      # no CUDA here
    assert t["fenerf/render"]["host_ms"] >= t["fenerf/render/field"][
        "host_ms"] > 0
    rec = profiling._SPANS
    assert all(r.parent is rec[-1] for r in rec[:-1])
    assert rec[-1].name == "fenerf/render" and rec[-1].parent is None


def test_self_time_is_total_less_children():
    rec = profiling.SpanRecord

    def made(name, parent, device_ms, **counts):
        r = rec(name, parent, counts)
        r.host_start, r.host_end, r.device_ms = 0.0, 1e-3, device_ms
        return r

    root = made("fenerf/render", None, 10.0)
    a = made("fenerf/render/field", root, 3.0, rows=5)
    b = made("fenerf/render/field", root, 4.0, rows=7)
    c = made("fenerf/inner", a, 1.0)
    lost = made("fenerf/inner", made("fenerf/gone", None, 9.0), 2.0)
    t = profiling.totals([c, a, b, root, lost])
    assert t["fenerf/render"]["device_ms"] == 10.0
    assert t["fenerf/render"]["self_device_ms"] == 10.0 - 3.0 - 4.0
    assert t["fenerf/render/field"] == {
        "calls": 2, "host_ms": pytest.approx(2.0), "device_ms": 7.0,
        "self_device_ms": 7.0 - 1.0, "counts": {"rows": 12}}
    assert t["fenerf/inner"]["self_device_ms"] == 3.0
    assert "fenerf/gone" not in t


def test_trace_writes_the_span_table(spans, tmp_path):
    with profiling.span("fenerf/before"):
        pass
    with profiling.trace(str(tmp_path)):
        with profiling.span("fenerf/x", rows=4):
            torch.ones(8).sum()
    table = json.loads((tmp_path / "spans.json").read_text())
    assert set(table) == {"fenerf/x"}
    assert table["fenerf/x"]["calls"] == 1
    assert table["fenerf/x"]["counts"] == {"rows": 4}
    assert (tmp_path / "trace.json").is_file()


def test_allreduce_span_counts_its_bytes(spans, monkeypatch):
    """Group.sum_tree's one flat all-reduce per call, under the span
    fenerf/train/allreduce with its f32 bytes (the collective stubbed: a
    second rank that holds the same tree)."""
    monkeypatch.setattr(torch.distributed, "all_reduce",
                        lambda t, op=None: t.mul_(2))
    group = dataclasses.replace(sharding.Group(), world=2)
    tree = {"a": torch.ones(2, 3), "b": torch.arange(5.0)}
    out, names = _profiled(lambda: group.sum_tree(tree))
    assert "fenerf/train/allreduce" in names
    torch.testing.assert_close(out["b"], 2 * tree["b"])
    t = profiling.span_totals()["fenerf/train/allreduce"]
    assert t["calls"] == 1 and t["counts"] == {"bytes": 4 * 11}


def test_render_bit_equal_with_and_without_profiler(spans):
    off = _render()
    on, _ = _profiled(_render)
    for k in off:
        assert torch.equal(off[k], on[k]), k


def _step(meta):
    state = tloop.init_train_state(meta, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    b, n = meta.batch_size, meta.img_size
    imgs = torch.rand(b, 3, n, n, generator=g) * 2 - 1
    labels = torch.rand(b, 18, n, n, generator=g) * 2 - 1
    state, metrics = tloop.train_step(
        state, imgs, labels,
        tloop.StepScalars(alpha=1.0, noise_std=0.0, topk_frac=1.0), meta,
        generator=g)
    return state, metrics


def test_train_step_phases_and_bit_equal(spans):
    meta = dataclasses.replace(
        tcur.CURRICULA["CelebA_double_semantic_texture_embedding_256_dim_96"]
        .at_step(0), **TINY)
    old = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        s_off, m_off = _step(meta)
        (s_on, m_on), _ = _profiled(lambda: _step(meta), names=False)
    finally:
        torch.use_deterministic_algorithms(old)
    for k in m_off:
        assert torch.equal(torch.as_tensor(m_off[k]),
                           torch.as_tensor(m_on[k])), k
    for a, b in zip(tree_leaves(s_off), tree_leaves(s_on)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    phases = {"fenerf/train/d_img", "fenerf/train/d_seg", "fenerf/train/g"}
    t = profiling.span_totals()
    assert phases <= set(t)
    assert all(t[p]["calls"] == 1 for p in phases)
    # a render per microbatch of each phase, inside the phase's span
    assert t["fenerf/render"]["calls"] == 3 * meta.batch_split
    assert t["fenerf/render/field"]["calls"] == 2 * 3 * meta.batch_split
    assert {r.parent.name for r in profiling._SPANS
            if r.name == "fenerf/render"} == phases
