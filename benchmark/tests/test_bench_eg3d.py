"""The EG3D render cell at a tiny size on the CPU: it comes out correct,
each of its faults not correct, the control fails one of its limits, and a
traced run reads its spans.

  python -m pytest benchmark/tests/test_bench_eg3d.py -q -p no:cacheprovider
"""
import pytest

from benchmark.harness import core, registry
from benchmark.reference import precision
from benchmark.tests import tiny

EG3D = {"z_dim": 16, "w_dim": 16, "plane_res": 16, "plane_ch": 8,
        "channel_base": 256, "channel_max": 32, "decoder_hidden": 16,
        "sr_in": 8, "sr_channels": [16, 8], "img_resolution": 32}
EG3D_RENDER = {"img_size": 8, "num_steps": 6, "ray_chunk": 16, "batch": 2,
               "check_images": 3, "trace_batches": 2}
CELL = "eg3d-render-512"


def tiny_run(seed=2 ** 31 + 11, trace=False):
    run = core.Run(CELL, seed, 0.2, trace, device="cpu",
                   overrides={"config": EG3D, "traffic": EG3D_RENDER})
    run.reference = precision.EXACT
    return run


def test_sound_cell_is_correct():
    res = tiny.execute(tiny_run())
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(registry.driver(
    registry.traffic(registry.workload(CELL)["traffic"])["driver"]
).faults()))
def test_fault_is_not_correct(fault):
    run = tiny_run()
    with run.driver.faults()[fault]():
        assert not tiny.execute(run)["correct"]


def test_eg3d_control_fails_a_limit():
    run = tiny_run()
    gaps = run.driver.control(run, run.reference.lowered())
    limits = run.cell["limits"]
    assert any(gaps[k] > limits[k] for k in limits), (gaps, limits)


def _ms(t, name):
    """A span's device ms where the CPU recorded none: its host ms."""
    return {**t[name], "device_ms": t[name]["host_ms"],
            "self_device_ms": t[name]["host_ms"]}


def test_eg3d_traced_run_reads_its_spans(monkeypatch):
    from fenerf_tpu_torch.utils import profiling

    run = tiny_run(trace=True)
    read = profiling.span_totals
    names = ("fenerf/eg3d/backbone", "fenerf/render/field/planes",
             "fenerf/eg3d/superres")
    monkeypatch.setattr(profiling, "span_totals", lambda: {
        n: _ms(t, n) if n in names else v
        for t in [read()] for n, v in t.items()})
    res = tiny.execute(run)
    t = run.facts["span_totals"]
    images = run.facts["images"]
    assert t["fenerf/eg3d/backbone"]["counts"] == {"planes": 3 * images}
    assert t["fenerf/eg3d/superres"]["counts"] == {"pixels": images * 32 ** 2}
    for metric, span in zip(("backbone_ms.render", "planes_ms.render",
                             "superres_ms.render"), names):
        assert res["metrics"][metric]["value"] == \
            pytest.approx(t[span]["device_ms"] / images)
    # images x rays per block x samples
    assert res["metrics"]["field_rows_per_call.render"]["value"] == 2 * 16 * 6
    assert "mfu.render" in res["metrics"]
