"""The readers' arithmetic on a synthetic profiler timeline."""
import json

import pytest

from benchmark.harness import readers, registry, trace

PEAKS = registry.device_peaks()
FILM = json.loads((registry.ROOT / "configs/film-dim96.json").read_text())
GRID = json.loads((registry.ROOT / "configs/grid-siren.json").read_text())


def _timeline():
    # window 0..1000 us; kernels overlap (a: 100-300, b: 200-400), c alone
    device = [("(anonymous namespace)::film_mlp_kernel(float const*)",
               100.0, 300.0),
              ("void at::native::reduce_kernel<512>(X)", 200.0, 400.0),
              ("sm90_xmma_fprop_implicit_gemm", 600.0, 700.0),
              ("bwd_rows_kernel(float const*)", 950.0, 1100.0)]
    host = [("bench/window", 0.0, 1000.0), ("bench/render", 50.0, 800.0),
            ("aten::cat", 420.0, 650.0)]
    return trace.Timeline(device, host, 0.0, 1000.0)


def test_idle_union_counts_overlap_once():
    tl = _timeline()
    # busy: 100-400 (300), 600-700 (100), 950-1000 (50, clipped) = 450 us
    assert trace.busy_s(tl) == pytest.approx(450e-6)
    assert trace.idle_share(tl) == pytest.approx(55.0)


def test_idle_gaps_named_by_host_op():
    gaps = trace.idle_gaps(_timeline())
    # 700-950, 400-600 (aten::cat starts after the gap does), 0-100
    assert gaps == [["bench/render", pytest.approx(250e-6)],
                    ["bench/render", pytest.approx(200e-6)],
                    ["none", pytest.approx(100e-6)]]


def test_kernel_names_match_whole_function_names():
    assert readers.is_kernel(
        "(anonymous namespace)::film_mlp_kernel(float const*)",
        readers.FILM_MLP)
    assert readers.is_kernel("void film_mlp_kernel<1>(Params)",
                             readers.FILM_MLP)
    assert not readers.is_kernel("film_mlp_kernel_other(int)",
                                 readers.FILM_MLP)
    assert not readers.is_kernel("void at::native::reduce_kernel<512>(X)",
                                 readers.FILM_MLP_BWD)
    assert readers.is_kernel(
        "(anonymous namespace)::reduce_kernel(float const*, int)",
        readers.FILM_MLP_BWD)
    assert readers.is_conv("sm90_xmma_fprop_implicit_gemm")
    assert not readers.is_conv("bwd_rows_kernel(float const*)")
    s, n = readers.device_time(_timeline(), readers.is_conv)
    assert (s, n) == (pytest.approx(100e-6), 1)


def test_film_flops_by_hand():
    f = registry.flops(FILM)
    # 2 (3*256 + 7*256^2 + 256*19 + 291*256 + 2*256^2 + 256*3)
    assert f.field_flops_per_point(FILM) == 1_341_440
    assert f.field_bytes_per_row(FILM) == 12 + 12 + 64 + 88
    # an image: 128^2 rays x 48 samples
    ops = f.render_ops(FILM, 1, 128, 24)
    assert ops["bfloat16"] == 128 * 128 * 48 * 1_341_440
    assert ops["bfloat16"] == pytest.approx(1.055e12, rel=1e-3)


def test_grid_flops_by_hand():
    f = registry.flops(GRID)
    assert f.mapping_flops_per_point(GRID) == 2 * (32 * 256 + 256 * 256
                                                   + 256 * 4608)
    assert f.mapping_flops_per_point(GRID) == pytest.approx(2.51e6,
                                                            rel=2e-3)
    assert f.film_flops_per_point(GRID) == 2 * (3 * 256 + 7 * 256 * 256
                                                + 259 * 256)


def test_critic_flops_by_hand():
    f = registry.flops(FILM)
    # a 4 x 4 input enters at block 6 (400 -> 400 at 4, then 2 x 2 final)
    got = f.critic_flops(FILM, 3, 4, fade=False)
    want = (2 * 16 * 3 * 400 + 2 * 16 * 9 * 402 * 400
            + 2 * 4 * 9 * 402 * 400 + 2 * 4 * 400 * 400 + 2 * 4 * 400 * 515)
    assert got == want


def test_roofline_and_mfu_arithmetic():
    # 1e12 bf16 products in 1 ms of kernel time: 1.011 ms at the peak
    need = readers.least_seconds(989e12 * 1e-3, 1.0, PEAKS)
    assert need == pytest.approx(1e-3)
    # bytes bound: 3.35e9 bytes -> 1 ms
    assert readers.least_seconds(1.0, 3.35e9, PEAKS) == pytest.approx(1e-3)
    share = readers.peak_share({"bfloat16": 989e12 * 0.1,
                                "float32": 67e12 * 0.05}, 1.0, PEAKS)
    assert share == pytest.approx(15.0)


class _Run:
    def __init__(self, facts, timeline, traffic, config):
        self.facts, self.timeline = facts, timeline
        self.traffic, self.config = traffic, config
        self.peaks = PEAKS
        self.flops = registry.flops(config)


def test_readers_on_a_render_timeline():
    tl = _timeline()
    rs = registry.metric_readers()
    run = _Run({"kind": "render", "images": 1, "rays_per_image": 16,
                "samples": 4}, tl, {"img_size": 4, "num_steps": 2}, FILM)
    assert rs["idle.render"].read(run) == pytest.approx(55.0)
    assert rs["idle.train"].read(run) is None
    rows = 64
    need = max(rows * 1_341_440 / 989e12,
               (rows * 176 + 2 * run.flops.field_weights(FILM)) / 3.35e12)
    assert rs["film_mlp_roofline.render"].read(run) == pytest.approx(
        100 * need / 200e-6)
    ops = run.flops.render_ops(FILM, 1, 4, 2)
    assert rs["mfu.render"].read(run) == pytest.approx(
        100 * (ops["bfloat16"] / 989e12 + ops["float32"] / 67e12) / 1e-3)
    assert rs["critics_ms.train"].read(run) is None


def test_readers_on_a_train_timeline():
    tl = _timeline()
    rs = registry.metric_readers()
    run = _Run({"kind": "train", "steps": 2, "g_rows_per_step": 100,
                "window_peak_bytes": 3 * 2 ** 30}, tl,
               {"batch": 2, "img_size": 4, "num_steps": 2}, FILM)
    assert rs["critics_ms.train"].read(run) == pytest.approx(0.05)
    assert rs["peak_mem_gib.train"].read(run) == pytest.approx(3.0)
    # the bwd rows kernel is clipped to 50 us of the window
    f = run.flops
    need = max(2 * 200 * f.field_flops_per_point(FILM) / 989e12,
               (200 * f.field_bwd_bytes_per_row(FILM)
                + 6 * f.field_weights(FILM)) / 3.35e12)
    assert rs["film_mlp_bwd_roofline.train"].read(run) == pytest.approx(
        100 * need / 50e-6)
    assert rs["film_mlp_roofline.render"].read(run) is None


def test_profiled_window_holds_the_harness_spans():
    import torch
    from torch.profiler import record_function

    sink = {}
    with trace.profiled(True, sink):
        with record_function("bench/render"):
            torch.ones(64).sum()
    tl = sink["timeline"]
    names = {n for n, _, _ in tl.host}
    assert "bench/render" in names and trace.WINDOW_SPAN in names
    assert not any(n.startswith("bench/") for n, _, _ in tl.device)
    assert tl.window_s > 0
    with trace.profiled(False, sink):
        pass
