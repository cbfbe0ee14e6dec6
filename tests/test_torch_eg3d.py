"""EG3D's tri-plane generator on the port (nn/triplane_field.py, the
conditioned mapping and synthesis network of nn/stylegan.py, EG3D's camera
in core/rays.py, MipRayMarcher2 and the importance weights' smoothing in
core/integrate.py, models/generator.py::render_eg3d) against the plain
reference tests/eg3d_reference.py, which imports nothing of the port, on
seeded random weights at a small size: planes 16 x 16, channels <= 32,
8 x 8 rendering at 6 + 6 samples, super-resolution 8 -> 32, float32."""
import math

import pytest
import torch

import eg3d_reference as ref
from fenerf_tpu_torch.apps import common, render_multiview
from fenerf_tpu_torch.core import integrate, rays
from fenerf_tpu_torch.models import generator as gen
from fenerf_tpu_torch.nn import triplane_field as tpf
from fenerf_tpu_torch.utils import profiling

SMALL = dict(z_dim=16, w_dim=16, plane_res=16, plane_ch=8, channel_base=256,
             channel_max=32, decoder_hidden=16, sr_in=8, sr_channels=(32, 16))
B, N, S = 2, 8, 6


@pytest.fixture(scope="module")
def model():
    g = torch.Generator().manual_seed(20221)
    sd = ref.init_state(g, ref.Sizes(**SMALL), noise_std=0.5)
    sd["decoder.net.2.bias"][0] += 5.0      # an opaque volume
    cfg = tpf.get_triplane_config(**SMALL)
    z = torch.randn(B, SMALL["z_dim"], generator=g)
    yaw = math.pi / 2 + 0.3 * torch.randn(B, 1, generator=g)
    pitch = math.pi / 2 + 0.155 * torch.randn(B, 1, generator=g)
    jitter = torch.rand(B, N * N, S, generator=g)
    u = torch.rand(B, N * N, S, generator=g)
    return sd, tpf.params_from_eg3d(sd, cfg), cfg, z, yaw, pitch, jitter, u


def _close(a, b, tol):
    assert a.shape == b.shape
    gap = float((a - b).abs().max())
    assert gap <= tol * max(1.0, float(b.abs().max())), gap


def test_label_and_rays_match(model):
    *_, yaw, pitch, _, _ = model
    c = ref.label(ref.cam2world(yaw, pitch))
    mine = rays.eg3d_label(rays.lookat_cam2world(yaw, pitch),
                           rays.eg3d_intrinsics(B))
    _close(mine, c, 1e-6)
    for a, b in zip(rays.eg3d_rays(mine, N), ref.rays(c, N)):
        _close(a, b, 1e-6)


def test_backbone_planes(model):
    sd, params, cfg, z, yaw, pitch, *_ = model
    c = ref.label(ref.cam2world(yaw, pitch))
    w = tpf.mapping(params, z, c)
    _close(w, ref.mapping(sd, z, c), 1e-5)
    planes = tpf.planes(params, cfg, w)
    assert planes.shape == (B, 3, 8, 16, 16)
    _close(planes, ref.synthesis(sd, ref.Sizes(**SMALL), w), 1e-5)


def test_projection_and_sampling():
    g = torch.Generator().manual_seed(3)
    pts = torch.rand(B, 50, 3, generator=g) - 0.5
    proj = tpf.project(pts, box_warp=1.0)
    x, y, z = (2 * pts).unbind(-1)
    # (x, y), (x, z) and EG3D's (z, x) for the third plane
    for k, (a, b) in enumerate(((x, y), (x, z), (z, x))):
        assert torch.equal(proj[:, k], torch.stack([a, b], -1))
    planes = torch.randn(B, 3, 8, 16, 16, generator=g)
    want = ref.sample_planes(planes, pts, 1.0, ref.EXACT).mean(1)
    _close(tpf.sample_planes(planes, pts), want, 1e-6)


def test_decoder(model):
    sd, params, cfg, *_ = model
    feats = torch.randn(B, 3, 40, 8, generator=torch.Generator().manual_seed(5))
    rgb, sigma = ref.decoder(sd, feats, ref.EXACT)
    out = tpf.decode(params, cfg, feats.mean(1))
    _close(out[..., :-1], rgb, 1e-6)
    _close(out[..., -1:], sigma, 1e-6)


def test_marcher_on_a_two_interval_ray():
    """Three samples at depths 1, 2, 4: midpoint densities softplus(s - 1),
    alphas, the shifted transmittance and the depth by hand."""
    z = torch.tensor([[1.0, 2.0, 4.0]])
    sigma = torch.tensor([[1.0, 3.0, 2.0]])
    colors = torch.tensor([[[0.0], [1.0], [0.5]]])
    comp, depth, w = integrate.mip_march(colors, sigma, z)
    sp = lambda v: math.log1p(math.exp(v))
    a1 = 1 - math.exp(-sp(2.0 - 1) * 1.0)
    a2 = 1 - math.exp(-sp(2.5 - 1) * 2.0)
    w1, w2 = a1, a2 * (1 - a1 + 1e-10)
    assert torch.allclose(w, torch.tensor([[w1, w2]]), atol=1e-6)
    assert abs(float(comp) - (w1 * 0.5 + w2 * 0.75)) < 1e-6
    assert abs(float(depth) - (w1 * 1.5 + w2 * 3.0) / (w1 + w2)) < 1e-6


def test_importance_smoothing_lengths():
    w = torch.rand(B, 5, S - 1, generator=torch.Generator().manual_seed(9))
    sm = integrate.smooth_importance_weights(w)
    assert sm.shape == w.shape
    # max over the neighbours (edges padded), then their pair means, + 0.01
    m = torch.maximum(torch.cat([w[..., :1], w], -1),
                      torch.cat([w, w[..., -1:]], -1))
    _close(sm, 0.5 * (m[..., :-1] + m[..., 1:]) + 0.01, 1e-7)
    # the pdf runs over the S - 1 midpoints with the S - 3 interior weights
    z = torch.sort(torch.rand(B, 5, S, generator=torch.Generator()
                              .manual_seed(1)), -1).values
    u = torch.rand(B, 5, S, generator=torch.Generator().manual_seed(2))
    fine = integrate.sample_pdf(integrate.midpoints(z), sm[..., 1:-1], S, u=u)
    want = ref.sample_pdf(integrate.midpoints(z).reshape(-1, S - 1),
                          sm[..., 1:-1].reshape(-1, S - 3),
                          u.reshape(-1, S)).reshape(B, 5, S)
    _close(fine, want, 1e-6)


def test_public_entry_matches_the_reference(model):
    sd, params, cfg, z, yaw, pitch, jitter, u = model
    c = ref.label(ref.cam2world(yaw, pitch))
    want = ref.generate(sd, ref.Sizes(**SMALL),
                        ref.RenderSpec(img_size=N, num_steps=S, ray_chunk=16),
                        z, c, jitter, u)
    rcfg = gen.eg3d_render_config(img_size=N, num_steps=S, ray_chunk=16)
    draws = gen.RenderDraws(jitter, None, None, gen.RayNoise(u, None, None))
    out = gen.render_eg3d(params, cfg, rcfg, z, c, draws=draws)
    assert out["image"].shape == (B, 3, 32, 32)
    assert float(out["opacity"].min()) > 0.5
    _close(out["image_raw"], want["image_raw"], 1e-5)
    _close(out["depth"], want["depth"], 1e-5)
    _close(out["image"], want["image"], 1e-5)
    # the ray blocks do not change the answer
    whole = gen.render_eg3d(params, cfg, gen.eg3d_render_config(
        img_size=N, num_steps=S, ray_chunk=0), z, c, draws=draws)
    _close(whole["image"], out["image"], 1e-6)


def test_spans_and_counts(model):
    _, params, cfg, z, yaw, pitch, jitter, u = model
    c = ref.label(ref.cam2world(yaw, pitch))
    rcfg = gen.eg3d_render_config(img_size=N, num_steps=S, ray_chunk=16)
    draws = gen.RenderDraws(jitter, None, None, gen.RayNoise(u, None, None))
    profiling.reset_spans()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        gen.render_eg3d(params, cfg, rcfg, z, c, draws=draws)
    t = profiling.span_totals()
    profiling.reset_spans()
    blocks = N * N // 16
    assert t["fenerf/eg3d/backbone"]["counts"] == {"planes": 3 * B}
    assert t["fenerf/render"]["calls"] == 1
    assert t["fenerf/render/field"]["calls"] == 2 * blocks
    planes = t["fenerf/render/field/planes"]
    assert planes["calls"] == 2 * blocks
    assert planes["counts"] == {"rows": B * N * N * 2 * S}
    assert t["fenerf/eg3d/superres"]["counts"] == {"pixels": B * 32 * 32}


def test_checkpoint_and_multiview(model, tmp_path):
    _, params, cfg, *_ = model
    path = str(tmp_path / "g.npz")
    common.save_generator(path, params, params, params, "TriPlaneGenerator",
                          7, SMALL)
    loaded, _, _, cfg2, config = common.load_generator(path, device="cpu")
    assert config["family"] == "eg3d" and cfg2 == cfg
    sheets = render_multiview.main([
        "--ckpt", path, "--seeds", "4", "--image_size", "8", "--num_steps",
        "3", "--ray_chunk", "16", "--psi", "1", "--device", "cpu",
        "--output_dir", str(tmp_path / "out")])
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == \
        ["depth_4.png", "img_4.png"]
    (seed, views, _), = sheets
    assert views.shape == (5, 3, 32, 32)
    front = rays.eg3d_label(
        rays.lookat_cam2world(torch.full((1, 1), math.pi / 2),
                              torch.full((1, 1), math.pi / 2)),
        rays.eg3d_intrinsics(1))
    z = torch.randn((1, cfg.z_dim), generator=torch.Generator().manual_seed(4))
    one = gen.render_eg3d(loaded, cfg, gen.eg3d_render_config(
        img_size=8, num_steps=6, ray_chunk=16), z, front,
        generator=torch.Generator().manual_seed(0))
    _close(torch.from_numpy(views[2]), one["image"][0], 1e-6)


def test_benchmark_reference_copy_matches(model):
    """benchmark/reference/eg3d.py, the cell's copy of the reference, gives
    the same weights and the same images as tests/eg3d_reference.py at
    float32, so the two cannot drift apart."""
    from benchmark.reference import eg3d as bench_ref

    *_, z, yaw, pitch, jitter, u = model
    sizes = dict(SMALL, sr_channels=tuple(SMALL["sr_channels"]))
    sd = ref.init_state(torch.Generator().manual_seed(5), ref.Sizes(**sizes),
                        noise_std=0.5)
    sd2 = bench_ref.init_state(torch.Generator().manual_seed(5),
                               bench_ref.Sizes(**sizes), noise_std=0.5)
    assert sorted(sd) == sorted(sd2)
    for k in sd:
        assert torch.equal(sd[k], sd2[k]), k
    c = ref.label(ref.cam2world(yaw, pitch))
    assert torch.equal(c, bench_ref.label(bench_ref.cam2world(yaw, pitch)))
    spec = dict(img_size=N, num_steps=S, ray_chunk=16)
    want = ref.generate(sd, ref.Sizes(**sizes), ref.RenderSpec(**spec), z, c,
                        jitter, u)
    got = bench_ref.generate(sd2, bench_ref.Sizes(**sizes),
                             bench_ref.RenderSpec(**spec), z, c, jitter, u)
    for k in want:
        assert torch.equal(got[k], want[k]), k
