"""The hand-written CUDA kernels (fenerf_tpu_torch/ops/csrc/film_mlp.cu,
film_mlp_bwd.cu, ray_finalize.cu, zexp_fold.cu, mxu_chain.cu, mxu_wide.cu,
dma_gather.cu) against their plain torch versions on the card, and their
wrappers' input checks; BiSeNet and the neural renderer (cuDNN, TF32 off)
on the card against the CPU, and the HD sheet's field on the kernel
against its torch route. Skips without an NVIDIA GPU.

Imports no JAX, so it runs on a machine without it:
  python -m pytest --noconftest -q tests/test_torch_kernel_cuda.py
"""
import pytest
import torch

from fenerf_tpu_torch.compat.jax_bridge import tree_map
from fenerf_tpu_torch.core.grid_sample import build_zexp_table, sample_zexp_table
from fenerf_tpu_torch.nn import fields
from fenerf_tpu_torch.ops import film_mlp as ops

FLAGSHIP = "TextureEmbeddingPiGAN256SEMANTICDISENTANGLE_DIM_96"
# bf16 operands on both sides; they differ only in f32 summation order
TOL = 2e-2

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("name,kw,b,n", [
    (FLAGSHIP, dict(grid_resolution=16), 1, 4096 * 4),     # full width
    # a block of the inversion's eval render: ray_chunk 8192 x 48 samples
    (FLAGSHIP, dict(grid_resolution=16), 1, 8192 * 48),
    # a block of render_video's frame: ray_chunk 4096 x 24 samples
    (FLAGSHIP, dict(grid_resolution=16), 1, 4096 * 24),
    (FLAGSHIP, dict(grid_resolution=16), 3, 1001),         # ragged tiles
    (FLAGSHIP, dict(grid_resolution=16), 3, 200),          # tiles straddle
    (FLAGSHIP, dict(grid_resolution=16), 1, 37),           # < 64 rows
    # more tiles than SMs, N % 128 != 0: a CTA's tile that runs into the
    # next element follows one that lay wholly in the first
    (FLAGSHIP, dict(grid_resolution=16), 2, 20000),
    # every tile touches three or more batch elements: the FiLM rows come
    # from device memory, not from the staged tables
    (FLAGSHIP, dict(grid_resolution=16), 3, 37),
    (FLAGSHIP, dict(grid_resolution=16), 5, 20),
    ("SIRENBASELINESEMANTICDISENTANGLE", {}, 2, 333),
    ("SPATIALSIRENSEMANTIC", {}, 2, 257),                  # label_film
    ("EmbeddingPiGAN128SEMANTICDISENTANGLE", dict(grid_resolution=16), 2, 500),
    ("TextureEmbeddingPiGAN128SEMANTICDISENTANGLE_WO_DIR",
     dict(grid_resolution=16), 2, 129),
    ("SPATIALSIRENSEMANTICHD", {}, 1, 200),                # 64-wide heads
])
def test_kernel_matches_plain_version(device, name, kw, b, n):
    cfg = fields.get_config(name, **kw)
    gen = torch.Generator(device=device).manual_seed(0)
    params = fields.init_field(gen, cfg, device=device)
    params["sigma_head"]["b"] = params["sigma_head"]["b"] + 5.0
    pts = torch.randn(b, n, 3, generator=gen, device=device) * 0.1
    dirs = torch.nn.functional.normalize(
        torch.randn(b, n, 3, generator=gen, device=device), dim=-1)
    zg = torch.randn(b, cfg.z_geo_dim, generator=gen, device=device)
    za = torch.randn(b, cfg.z_app_dim, generator=gen, device=device)
    fg, fa = fields.field_film(params, cfg, zg, za)
    warped = pts * (2.0 / cfg.box_side) if cfg.box_side else pts
    gf = None
    if cfg.grid_channels:
        table = build_zexp_table(params["grid"], torch.bfloat16)
        gf = sample_zexp_table(table, params["grid"].shape, warped)
    pack = ops.pack(params, cfg)
    launches = ops.film_mlp.launches
    out = ops.film_mlp(pack, warped, dirs, gf, fg, fa)
    assert ops.film_mlp.launches == launches + 1
    ref = ops.film_mlp_reference(pack, warped, dirs, gf, fg, fa)
    torch.cuda.synchronize()
    assert out.shape == (b, n, cfg.output_dim)
    assert torch.isfinite(out).all()
    err = (out - ref).abs().max().item()
    assert err <= TOL, err


def test_wrapper_rejects_bad_input(device):
    cfg = fields.get_config("SIRENBASELINESEMANTICDISENTANGLE", hidden_dim=32,
                            z_geo_dim=8, z_app_dim=8)
    gen = torch.Generator(device=device).manual_seed(0)
    params = fields.init_field(gen, cfg, device=device)
    fg, fa = fields.field_film(params, cfg, torch.zeros(1, 8, device=device),
                               torch.zeros(1, 8, device=device))
    pack = ops.pack(params, cfg)
    pts = torch.zeros(1, 10, 3, device=device)
    with pytest.raises(ValueError, match="ray_dirs"):
        ops.film_mlp(pack, pts, torch.zeros(1, 10, 3, device=device,
                                           dtype=torch.float64), None, fg, fa)
    cpu_pack = ops.pack(tree_map(lambda t: t.cpu(), params), cfg)
    with pytest.raises(ValueError, match="pack"):
        ops.film_mlp(cpu_pack, pts, pts, None, fg, fa)


@pytest.mark.parametrize("name,kw,b,n", [
    (FLAGSHIP, dict(grid_resolution=16), 2, 4096),         # full width
    # an inversion step: B=1, 128^2 x 24 samples
    (FLAGSHIP, dict(grid_resolution=16), 1, 128 * 128 * 24),
    (FLAGSHIP, dict(grid_resolution=16), 3, 1001),         # ragged tiles
    (FLAGSHIP, dict(grid_resolution=16), 3, 200),          # ragged, 2 tiles
    (FLAGSHIP, dict(grid_resolution=16), 1, 37),           # < 64 rows
    # more tiles than SMs, N % 128 != 0
    (FLAGSHIP, dict(grid_resolution=16), 2, 20000),
    # the 64^2 stage's G microbatch: 1,179,648 rows (~29 GB of scratch)
    (FLAGSHIP, dict(grid_resolution=16), 12, 64 * 64 * 24),
    ("SIRENBASELINESEMANTICDISENTANGLE", {}, 2, 333),
    ("SIRENBASELINESEMANTICDISENTANGLE_debug", {}, 2, 100),  # label sigmoid
    ("SPATIALSIRENBASELINESEMANTIC", {}, 1, 257),          # single latent
    ("SPATIALSIRENBASELINEHD", {}, 2, 130),                # 64 linear rgb
    ("TextureEmbeddingPiGAN128SEMANTICDISENTANGLE",
     dict(grid_resolution=16), 2, 500),                    # hidden 128
])
def test_backward_kernel_matches_plain_version(device, name, kw, b, n):
    from fenerf_tpu_torch.ops import film_mlp_grad as gops

    cfg = fields.get_config(name, **kw)
    gen = torch.Generator(device=device).manual_seed(0)
    params = fields.init_field(gen, cfg, device=device)
    pts = torch.randn(b, n, 3, generator=gen, device=device) * 0.1
    dirs = torch.nn.functional.normalize(
        torch.randn(b, n, 3, generator=gen, device=device), dim=-1)
    zg = torch.randn(b, cfg.z_geo_dim, generator=gen, device=device)
    za = torch.randn(b, cfg.z_app_dim, generator=gen, device=device)
    fg, fa = fields.field_film(params, cfg, zg, za)
    warped = pts * (2.0 / cfg.box_side) if cfg.box_side else pts
    gf = None
    if cfg.grid_channels:
        table = build_zexp_table(params["grid"], torch.bfloat16)
        gf = sample_zexp_table(table, params["grid"].shape, warped)
    g_out = torch.randn(b, n, cfg.output_dim, generator=gen, device=device)
    pack = gops.pack_bwd(params, cfg)
    launches = gops.film_mlp_bwd.launches
    out = gops.film_mlp_bwd(pack, warped, dirs, gf, fg, fa, g_out)
    assert gops.film_mlp_bwd.launches == launches + 1
    ref = gops.film_mlp_bwd_reference(pack, warped, dirs, gf, fg, fa, g_out)
    torch.cuda.synchronize()
    again = gops.film_mlp_bwd(pack, warped, dirs, gf, fg, fa, g_out)
    for x, y in zip(again[0], out[0]):      # no atomics: run to run equal
        assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
    bad = [row for row in gops.bwd_agreement(out, ref) if not row[3]]
    assert not bad, bad


def test_backward_kernel_is_bitwise_deterministic(device):
    """No atomics: two runs on the same inputs give the same bits in every
    output (dW, db, dpoints, ddirs, dgf and the film gradients)."""
    from fenerf_tpu_torch.ops import film_mlp_grad as gops

    cfg = fields.get_config(FLAGSHIP, grid_resolution=16)
    gen = torch.Generator(device=device).manual_seed(1)
    params = fields.init_field(gen, cfg, device=device)
    b, n = 2, 3000
    pts = torch.randn(b, n, 3, generator=gen, device=device) * 0.1
    dirs = torch.nn.functional.normalize(
        torch.randn(b, n, 3, generator=gen, device=device), dim=-1)
    zg = torch.randn(b, cfg.z_geo_dim, generator=gen, device=device)
    za = torch.randn(b, cfg.z_app_dim, generator=gen, device=device)
    fg, fa = fields.field_film(params, cfg, zg, za)
    warped = pts * (2.0 / cfg.box_side)
    table = build_zexp_table(params["grid"], torch.bfloat16)
    gf = sample_zexp_table(table, params["grid"].shape, warped)
    g_out = torch.randn(b, n, cfg.output_dim, generator=gen, device=device)
    pack = gops.pack_bwd(params, cfg)
    runs = [gops.film_mlp_bwd(pack, warped, dirs, gf, fg, fa, g_out)
            for _ in range(2)]
    torch.cuda.synchronize()
    (l0, *o0), (l1, *o1) = runs
    for (w0, b0), (w1, b1) in zip(l0, l1):
        assert torch.equal(w0, w1) and torch.equal(b0, b1)
    for x, y in zip(o0, o1):
        assert torch.equal(x, y)



def test_grad_rays_render_on_the_kernels(device):
    """grad_rays = 0.5 on the card: the subset renders through kernel_train
    (forward kernel, then the backward kernel), the rest under no_grad on
    the forward kernel alone; the pixels equal the grad_rays = 1 render's
    on the same draws, and only the subset's rays pass gradients."""
    import dataclasses

    from fenerf_tpu_torch.compat.jax_bridge import tree_leaves
    from fenerf_tpu_torch.models import generator as gen
    from fenerf_tpu_torch.ops import film_mlp_grad as gops

    cfg = fields.get_config(FLAGSHIP, grid_resolution=16)
    g = torch.Generator(device=device).manual_seed(5)
    params = fields.init_field(g, cfg, device=device)
    rcfg = gen.RenderConfig(img_size=16, num_steps=8, backend="kernel_train",
                            grad_rays=0.5)
    zg = torch.randn(2, cfg.z_geo_dim, generator=g, device=device)
    za = torch.randn(2, cfg.z_app_dim, generator=g, device=device)
    draws = gen.draw_render(g, 2, rcfg, 0.5, rcfg.sample_dist, device)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    fwd, bwd = ops.film_mlp.launches, gops.film_mlp_bwd.launches
    out = gen.render_from_z(params, cfg, rcfg, zg, za, 0.5, draws=draws)
    assert ops.film_mlp.launches == fwd + 4    # 2 passes x (subset, rest)
    mask = out["grad_ray_mask"]
    assert int(mask.sum()) == 128
    w = torch.randn(out["pixels"].shape, generator=g, device=device)
    grads = torch.autograd.grad((out["pixels"] * w).sum(), leaves,
                                allow_unused=True)
    assert gops.film_mlp_bwd.launches == bwd + 2   # the subset's passes
    assert any(gr is not None and gr.abs().max() > 0 for gr in grads)
    with torch.no_grad():
        full = gen.render_from_z(params, cfg, dataclasses.replace(
            rcfg, grad_rays=1.0), zg, za, 0.5, draws=draws)
    assert (out["pixels"].detach() - full["pixels"]).abs().max() <= 1e-6
    off = torch.autograd.grad(
        (gen.render_from_z(params, cfg, rcfg, zg, za, 0.5,
                           draws=draws)["pixels"] * w * (~mask)).sum(),
        leaves, allow_unused=True)
    assert all(gr is None or gr.abs().max() == 0 for gr in off)

# fused per-ray kernels (ops/csrc/ray_finalize.cu) against their plain
# versions: the same additions in the same order, differing in exp / log and
# the compositing sum's order (f32 over up to 2S terms)
RAY_TOL = 1e-4


def _ray_inputs(gen, device, b, r, s, c1=22):
    z0 = torch.linspace(0.88, 1.12, s, device=device)
    z = z0 + torch.rand(b, r, s, generator=gen, device=device) * (0.24 / s)
    opaque = torch.rand(b, r, 1, generator=gen, device=device) < 0.5
    sigma = (torch.randn(b, r, s, generator=gen, device=device) * 10
             + torch.where(opaque, 20.0, -5.0))
    out = lambda n: torch.cat([
        torch.rand(b, r, n, c1 - 1, generator=gen, device=device),
        (torch.randn(b, r, n, 1, generator=gen, device=device) * 10
         + torch.where(opaque, 20.0, -5.0)[..., None])], dim=-1)
    return z, sigma, out


@pytest.mark.parametrize("b,r,s", [(1, 64, 12), (3, 1001, 48), (2, 37, 5),
                                   (2, 300, 3), (1, 200, 256),
                                   (12, 4096, 24)])   # the 64^2 stage
@pytest.mark.parametrize("noisy", [True, False])
@pytest.mark.parametrize("clamp", ["relu", "softplus"])
def test_ray_resample_kernel_matches_plain(device, b, r, s, noisy, clamp):
    from fenerf_tpu_torch.ops import ray_finalize as rf

    gen = torch.Generator(device=device).manual_seed(1)
    z, sigma, _ = _ray_inputs(gen, device, b, r, s)
    noise = (torch.randn(b, r, s, generator=gen, device=device)
             if noisy else None)
    u = torch.rand(b, r, s, generator=gen, device=device)
    launches = rf.ray_resample.launches
    got = rf.ray_resample(sigma, z, noise, u, clamp)
    assert rf.ray_resample.launches == launches + 1
    ref = rf.ray_resample_reference(sigma, z, noise, u, clamp)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    assert err <= RAY_TOL, err


# the last seven: blocks that are not 16-byte multiples (7 x 5, 9 x 5 and
# 37 x 22 floats: the cp.async path), S_f + S_c = 256 with S_f != S_c, more
# rays than the persistent CTAs' warps hold in their rings (not a multiple
# of the rays per CTA), and stages too large for four warps of two (256 x
# 41 floats: two warps) or for two stages (256 x 128 floats: one warp, one
# stage)
@pytest.mark.parametrize("b,r,sf,sc,c1", [(2, 33, 8, 8, 5),
                                          (1, 1001, 48, 48, 22),
                                          (3, 129, 24, 24, 22),
                                          (2, 33, 7, 9, 5),
                                          (3, 1001, 37, 37, 22),
                                          (2, 257, 100, 156, 22),
                                          (3, 20011, 8, 8, 5),
                                          (2, 4099, 48, 48, 22),
                                          (1, 300, 128, 128, 41),
                                          (1, 150, 96, 160, 128),
                                          # the 64^2 stage's G microbatch
                                          (12, 4096, 24, 24, 22)])
@pytest.mark.parametrize("noisy", [True, False])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(fill_mode="seg_padding_background", softmax_label=True, last_back=True),
    dict(fill_mode="debug", white_back=True, clamp_mode="softplus")])
def test_ray_finalize_kernel_matches_plain(device, b, r, sf, sc, c1, noisy,
                                           kw):
    from fenerf_tpu_torch.ops import ray_finalize as rf

    gen = torch.Generator(device=device).manual_seed(2)
    cz, _, out = _ray_inputs(gen, device, b, r, sc, c1)
    fz = torch.rand(b, r, sf, generator=gen, device=device) * 0.24 + 0.88
    fz[..., 0] = cz[..., sc // 2]        # a tie: fine sorts first
    fo, co = out(sf), out(sc)
    noise = (torch.randn(b, r, sf + sc, generator=gen, device=device)
             if noisy else None)
    launches = rf.ray_finalize.launches
    got = rf.ray_finalize(fo, co, fz, cz, noise, **kw)
    assert rf.ray_finalize.launches == launches + 1
    ref = rf.ray_finalize_reference(fo, co, fz, cz, noise, **kw)
    torch.cuda.synchronize()
    for g, a in zip(got, ref):
        assert g.shape == a.shape and torch.isfinite(g).all()
        err = (g - a).abs().max().item()
        assert err <= RAY_TOL, err


@pytest.mark.parametrize("fill_mode", [None, "eval_white_back"])
def test_ray_kernels_at_the_grid_setting(device, fill_mode):
    """The latent-grid render's block (render_video at its defaults: 4096
    rays, 24 + 24 samples, no sigma noise): rgb + sigma outputs (C = 4),
    the white-background fill (or none, as the render passes it) and no
    label softmax."""
    from fenerf_tpu_torch.ops import ray_finalize as rf

    gen = torch.Generator(device=device).manual_seed(5)
    b, r, s = 1, 4096, 24
    z, sigma, out = _ray_inputs(gen, device, b, r, s, c1=4)
    u = torch.rand(b, r, s, generator=gen, device=device)
    fz = rf.ray_resample(sigma, z, None, u)
    fz_ref = rf.ray_resample_reference(sigma, z, None, u)
    fo, co = out(s), out(s)
    got = rf.ray_finalize(fo, co, fz, z, None, fill_mode=fill_mode)
    ref = rf.ray_finalize_reference(fo, co, fz, z, None, fill_mode=fill_mode)
    torch.cuda.synchronize()
    assert (fz - fz_ref).abs().max().item() <= RAY_TOL
    assert got[0].shape == (b, r, 3)
    for g, a in zip(got, ref):
        assert g.shape == a.shape and torch.isfinite(g).all()
        assert (g - a).abs().max().item() <= RAY_TOL


def test_ray_resample_kernel_more_uniforms_than_samples(device):
    """n_imp beyond the 32 x slots uniforms a warp holds at once (S = 12:
    one slot, 80 uniforms in three rounds)."""
    from fenerf_tpu_torch.ops import ray_finalize as rf

    gen = torch.Generator(device=device).manual_seed(7)
    z, sigma, _ = _ray_inputs(gen, device, 2, 50, 12)
    u = torch.rand(2, 50, 80, generator=gen, device=device)
    got = rf.ray_resample(sigma, z, None, u)
    ref = rf.ray_resample_reference(sigma, z, None, u)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= RAY_TOL


def test_ray_resample_kernel_non_monotone_cdf(device):
    """A z row with one descending step gives a negative weight, so the
    doubling-sum cdf dips: the kernel counts cdf_j < u one by one instead of
    bisecting, and still agrees with the plain version."""
    from fenerf_tpu_torch.ops import ray_finalize as rf

    gen = torch.Generator(device=device).manual_seed(10)
    b, r, s = 2, 300, 48
    z, _, _ = _ray_inputs(gen, device, b, r, s)
    z[..., [5, 6]] = z[..., [6, 5]]
    sigma = torch.rand(b, r, s, generator=gen, device=device) * 5 + 5
    u = torch.rand(b, r, s, generator=gen, device=device)
    got = rf.ray_resample(sigma, z, None, u)
    ref = rf.ray_resample_reference(sigma, z, None, u)
    # the plain version's cdf, as its body computes it
    alphas = 1.0 - torch.exp(-rf._deltas_last_1e10(z) * sigma.relu())
    w = alphas * torch.exp(rf._prefix_sum(torch.log(1.0 - alphas + 1e-10),
                                          exclusive=True))
    wm = torch.nn.functional.pad((w[..., 1:-1] + 1e-5) + 1e-5, (1, 1))
    cdf = rf._prefix_sum(wm / rf._prefix_sum(wm)[..., -1:])[..., :s - 1]
    torch.cuda.synchronize()
    assert (cdf[..., 1:] < cdf[..., :-1]).any(-1).all()
    assert (got - ref).abs().max().item() <= RAY_TOL


@pytest.mark.parametrize("order", ["coarse_ties", "coarse_shuffled"])
def test_ray_finalize_kernel_coarse_order(device, order):
    """Coarse z with equal neighbours (still non-decreasing: the bisection
    path, ties going to the lower index) and shuffled coarse z (every
    z_j counted one by one)."""
    from fenerf_tpu_torch.ops import ray_finalize as rf

    gen = torch.Generator(device=device).manual_seed(11)
    b, r, sf, sc = 2, 500, 48, 48
    cz, _, out = _ray_inputs(gen, device, b, r, sc)
    fz = torch.rand(b, r, sf, generator=gen, device=device) * 0.24 + 0.88
    if order == "coarse_ties":
        cz[..., 1::2] = cz[..., 0::2]
        fz[..., ::3] = cz[..., 4:4 + len(range(0, sf, 3))]
    else:
        cz = cz[..., torch.randperm(sc, generator=torch.Generator().manual_seed(0))
                .to(device)].contiguous()
    fo, co = out(sf), out(sc)
    noise = torch.randn(b, r, sf + sc, generator=gen, device=device)
    got = rf.ray_finalize(fo, co, fz, cz, noise, last_back=True)
    ref = rf.ray_finalize_reference(fo, co, fz, cz, noise, last_back=True)
    torch.cuda.synchronize()
    for g, a in zip(got, ref):
        assert torch.isfinite(g).all()
        assert (g - a).abs().max().item() <= RAY_TOL


def test_ray_finalize_kernel_off_16_byte_base(device):
    """Blocks of a 16-byte-multiple size (48 x 22 floats) whose tensor
    starts 4 bytes past a 16-byte boundary take the cp.async path and give
    the bulk-copy path's results bit for bit."""
    from fenerf_tpu_torch.ops import ray_finalize as rf

    gen = torch.Generator(device=device).manual_seed(8)
    b, r, s, c1 = 1, 700, 48, 22
    cz, _, out = _ray_inputs(gen, device, b, r, s, c1)
    fz = torch.rand(b, r, s, generator=gen, device=device) * 0.24 + 0.88
    fo, co = out(s), out(s)
    noise = torch.randn(b, r, 2 * s, generator=gen, device=device)

    def shifted(x):
        flat = torch.empty(x.numel() + 1, device=device)
        y = flat[1:].view(x.shape)
        y.copy_(x)
        assert y.is_contiguous() and y.data_ptr() % 16 == 4
        return y

    aligned = rf.ray_finalize(fo, co, fz, cz, noise, last_back=True)
    off = rf.ray_finalize(shifted(fo), shifted(co), fz, cz, noise,
                          last_back=True)
    ref = rf.ray_finalize_reference(fo, co, fz, cz, noise, last_back=True)
    torch.cuda.synchronize()
    for a, o, p in zip(aligned, off, ref):
        assert torch.equal(a, o)
        assert (a - p).abs().max().item() <= RAY_TOL


@pytest.mark.parametrize("sf,sc,c1", [(48, 48, 22), (37, 37, 22)])
def test_ray_kernels_bitwise_run_to_run_and_by_position(device, sf, sc, c1):
    """Both ray kernels give the same bits on every run, and a ray's result
    does not depend on where it lies in the launch: the rays of a slice,
    launched alone, equal the whole launch's (more rays than the persistent
    CTAs' rings hold, so the whole launch walks each warp over several)."""
    from fenerf_tpu_torch.ops import ray_finalize as rf

    gen = torch.Generator(device=device).manual_seed(9)
    b, r = 2, 4099
    cz, sigma, out = _ray_inputs(gen, device, b, r, sc, c1)
    u = torch.rand(b, r, sf, generator=gen, device=device)
    nz_c = torch.randn(b, r, sc, generator=gen, device=device)
    nz_f = torch.randn(b, r, sf + sc, generator=gen, device=device)
    fo, co = out(sf), out(sc)
    fz = rf.ray_resample(sigma, cz, nz_c, u)
    fz2 = rf.ray_resample(sigma, cz, nz_c, u)
    kw = dict(fill_mode="seg_padding_background", softmax_label=True)
    whole = rf.ray_finalize(fo, co, fz, cz, nz_f, **kw)
    again = rf.ray_finalize(fo, co, fz, cz, nz_f, **kw)
    assert torch.equal(fz, fz2)
    for x, y in zip(whole, again):
        assert torch.equal(x, y)
    part = slice(1000, 1777)
    sl = lambda x: x[1:, part].contiguous()
    fz_part = rf.ray_resample(sl(sigma), sl(cz), sl(nz_c), sl(u))
    assert torch.equal(fz_part, sl(fz))
    got = rf.ray_finalize(sl(fo), sl(co), sl(fz), sl(cz), sl(nz_f), **kw)
    for x, y in zip(got, whole):
        assert torch.equal(x, sl(y))


@pytest.mark.parametrize("grid_shape", [(3, 4, 5, 6), (32, 16, 16, 40),
                                        (8, 9, 7, 70)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_kernel_equals_plain(device, grid_shape, dtype):
    from fenerf_tpu_torch.ops import zexp_fold as zf

    c, d, h, w = grid_shape
    gen = torch.Generator(device=device).manual_seed(3)
    dt = torch.randn((d + 1) * (h + 1) * (w + 1), 8 * c, generator=gen,
                     device=device).to(dtype)
    launches = zf.fold_zexp.launches
    got = zf.fold_zexp(dt, grid_shape)
    assert zf.fold_zexp.launches == launches + 1
    ref = zf.fold_zexp_reference(dt, grid_shape)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, ref)


def test_table_fold_dispatches_to_the_kernel(device):
    """zexp_table_adjoint and the table build's backward launch the fold
    kernel for a CUDA tensor; a non-f32 out_dtype raises."""
    from fenerf_tpu_torch.core import grid_sample as gs
    from fenerf_tpu_torch.ops import zexp_fold as zf

    grid_shape = (4, 5, 6, 7)
    gen = torch.Generator(device=device).manual_seed(6)
    grid = torch.randn(grid_shape, generator=gen, device=device,
                       requires_grad=True)
    table = gs.build_zexp_table(grid, torch.bfloat16)
    # a bf16 cotangent, as the table's own backward receives
    dt = torch.randn(table.shape, generator=gen,
                     device=device).to(torch.bfloat16)
    launches = zf.fold_zexp.launches
    got = gs.zexp_table_adjoint(dt, grid_shape)
    (g,) = torch.autograd.grad((table * dt).float().sum(), grid)
    assert zf.fold_zexp.launches == launches + 2
    ref = gs.zexp_table_adjoint_torch(dt, grid_shape)
    assert torch.equal(got, ref) and torch.equal(g, ref)
    with pytest.raises(ValueError, match="float32"):
        gs.zexp_table_adjoint(dt, grid_shape, out_dtype=torch.bfloat16)


def test_ray_and_fold_wrappers_reject_bad_input(device):
    from fenerf_tpu_torch.ops import ray_finalize as rf
    from fenerf_tpu_torch.ops import zexp_fold as zf

    z = torch.rand(1, 8, 6, device=device)
    with pytest.raises(ValueError, match="sigma"):
        rf.ray_resample(z.double(), z, None, z)
    with pytest.raises(ValueError, match="u"):
        rf.ray_resample(z, z, None, z[:, :4])
    with pytest.raises(ValueError, match="z_vals"):
        rf.ray_resample(z, z.transpose(1, 2).contiguous().transpose(1, 2),
                        None, z)
    out = torch.rand(1, 8, 6, 5, device=device)
    with pytest.raises(ValueError, match="noise"):
        rf.ray_finalize(out, out, z, z, torch.rand(1, 8, 6, device=device))
    with pytest.raises(ValueError, match="coarse_out"):
        rf.ray_finalize(out, out[..., :4], z, z, None)
    with pytest.raises(ValueError, match="fill_mode"):
        rf.ray_finalize(out, out, z, z, None, fill_mode="paint")
    dt = torch.rand(4 * 4 * 4, 16, device=device)
    with pytest.raises(ValueError, match="dtable"):
        zf.fold_zexp(dt.half(), (2, 3, 3, 3))
    with pytest.raises(ValueError, match="dtable"):
        zf.fold_zexp(dt, (2, 3, 3, 4))


# the ceiling probes (ops/csrc/mxu_chain.cu, mxu_wide.cu, dma_gather.cu).
# Chains: bf16 operands on both sides, f32 sums in another order
# (max|diff|/max|plain|)
CHAIN_TOL = 2e-2


@pytest.mark.parametrize("n,h,layers,tile,k", [
    (1000, 256, 11, 64, 1), (1001, 256, 11, 128, 2), (77, 64, 3, 64, 1),
    (130, 512, 5, 64, 1), (300, 512, 5, 128, 1), (65, 192, 2, 128, 2),
    # fewer rows than a warpgroup; a second consumer with no rows at all;
    # width 128 in one pass; one layer over many tiles, where the next x
    # tile's copy is issued as soon as a buffer is released
    (37, 256, 11, 128, 1), (100, 256, 3, 128, 2), (300, 128, 4, 128, 1),
    (1 << 18, 256, 1, 128, 1),
    # run_wide: one warpgroup's rows; fewer; one layer over many tiles,
    # where a consumer refills its A tile right after its last products;
    # widths whose last pass is half padding
    (64, 512, 5, 128, 1), (37, 512, 5, 128, 1), (1 << 18, 512, 1, 128, 1),
    (300, 320, 3, 64, 1), (200, 448, 2, 128, 1)])
def test_chain_kernel_matches_plain(device, n, h, layers, tile, k):
    """Widths up to 256 on run_chain's wgmma kernel, above on run_wide's
    (A from shared memory)."""
    from fenerf_tpu_torch.ops import mxu_chain as mc
    from fenerf_tpu_torch.ops import probes

    gen = torch.Generator(device=device).manual_seed(7)
    x, w = probes.chain_inputs(gen, n, h, layers, device)
    fn = mc.run_wide if h > mc.MAX_WIDTH else mc.run_chain
    launches = fn.launches
    got = (mc.run_wide(x, w, tile) if fn is mc.run_wide
           else mc.run_chain(x, w, tile, interleave=k))
    assert fn.launches == launches + 1
    ref = mc.chain_reference(x, w)
    torch.cuda.synchronize()
    assert got.shape == (n, h) and got.dtype == torch.bfloat16
    err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err.item() <= CHAIN_TOL, err.item()
    # tiles and interleaves change the schedule, not a row's sums
    if fn is mc.run_wide:
        for tile2 in mc.WIDE_TILES:
            assert torch.equal(got, mc.run_wide(x, list(w), tile2))
    else:
        for tile2, k2 in mc.VARIANTS:
            assert torch.equal(got, mc.run_chain(x, list(w), tile2, k2))


@pytest.mark.parametrize("n,tile,k", [(1000, 64, 1), (1001, 128, 2),
                                      (333, 128, 2), (40, 64, 1),
                                      (333, 128, 1), (1 << 18, 128, 1)])
@pytest.mark.parametrize("fold", [False, True])
def test_epi_kernel_matches_plain(device, n, tile, k, fold):
    """At the field's weight scale over 11 layers (RMS-held: bf16 flips
    grow with depth) and on the JAX script's draw over 1 layer."""
    from fenerf_tpu_torch.ops import mxu_chain as mc
    from fenerf_tpu_torch.ops import probes

    gen = torch.Generator(device=device).manual_seed(8)
    x = probes.activations(gen, n, 256, device)
    for scale, layers in (("field", 11), ("script", 1)):
        w, b, f, p = probes.film_inputs(gen, layers, 256, device, scale)
        launches = mc.run_epi.launches
        got = mc.run_epi(x, w, b, f, p, tile, interleave=k, fold=fold)
        assert mc.run_epi.launches == launches + 1
        ref = mc.epi_reference(x, w, b, f, p, fold=fold)
        torch.cuda.synchronize()
        d = got.float() - ref.float()
        if layers == 1:
            assert d.abs().max().item() <= 2e-2
        else:
            assert d.square().mean().sqrt().item() <= 5e-3
            assert d.abs().max().item() <= 2.5e-1
        assert torch.equal(got, mc.run_epi(x, w, b, f, p, 64, fold=fold))


@pytest.mark.parametrize("h", [64, 128, 192, 256])
@pytest.mark.parametrize("fold", [False, True])
def test_chain_pack_kernel_writes_the_plain_layout(device, h, fold):
    """mxu_chain.cu's pack kernel writes pack_chain_weights' bytes (held to
    the wgmma layout rule on the CPU by tests/test_torch_chain_layout.py)."""
    from fenerf_tpu_torch.ops import mxu_chain as mc
    from fenerf_tpu_torch.ops import probes

    gen = torch.Generator(device=device).manual_seed(13)
    w, b, f, p = probes.film_inputs(gen, 3, h, device, "script")
    got, q = mc.pack_on_device(w, b, f, p, fold=fold)
    want, q_want = mc.pack_chain_weights(w, b, f, p, fold=fold)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    if fold:
        assert torch.equal(q, q_want)


@pytest.mark.parametrize("h", [320, 512])
def test_wide_pack_kernel_writes_the_plain_layout(device, h):
    """mxu_wide.cu's pack kernel (chain_pack.cuh, as mxu_chain.cu's) writes
    pack_chain_weights' bytes above width 256 too."""
    from fenerf_tpu_torch.ops import mxu_chain as mc
    from fenerf_tpu_torch.ops import probes

    gen = torch.Generator(device=device).manual_seed(14)
    _, w = probes.chain_inputs(gen, 1, h, 5, device)
    got, _ = mc.pack_on_device(w)
    want, _ = mc.pack_chain_weights(w)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("row_shape", [(8, 128), (256,), (24,), (8,)])
@pytest.mark.parametrize("n", [1024, 1024 + 37, 5])
def test_gather_kernel_equals_plain(device, row_shape, n):
    """Every ring the kernel takes, the largest beyond a ragged tile's
    rows."""
    from fenerf_tpu_torch.ops import dma_gather as dg

    gen = torch.Generator(device=device).manual_seed(9)
    table = torch.randn((3000,) + row_shape, generator=gen, device=device,
                        dtype=torch.bfloat16)
    idx = torch.randint(0, 3000, (n,), generator=gen, device=device,
                        dtype=torch.int32)
    ref = dg.gather_reference(table, idx)
    row_bytes = 2 * table[0].numel()
    for ring in dg.rings(row_bytes):
        launches = dg.ring_dma_gather.launches
        got = dg.ring_dma_gather(table, idx, ring)
        assert dg.ring_dma_gather.launches == launches + 1
        assert torch.equal(got, ref), ring


@pytest.mark.parametrize("row_shape", [(8, 128), (256,), (8,)])
def test_gather_kernel_zeroes_out_of_range_rows(device, row_shape):
    """An index < 0 or >= rows loads nothing and gives a row of zeros, at
    every ring, alone and beside the chain; the rows around it are
    gathered as usual."""
    from fenerf_tpu_torch.ops import dma_gather as dg
    from fenerf_tpu_torch.ops import probes

    gen = torch.Generator(device=device).manual_seed(11)
    rows, n = 3000, 1024 + 300
    table = torch.randn((rows,) + row_shape, generator=gen, device=device,
                        dtype=torch.bfloat16)
    idx = torch.randint(0, rows, (n,), generator=gen, device=device,
                        dtype=torch.int32)
    bad = torch.randperm(n, generator=torch.Generator().manual_seed(0))[:97]
    idx[bad.to(device)] = torch.tensor(
        [-1, rows, -(2 ** 31), 2 ** 31 - 1, rows + 5] * 20,
        dtype=torch.int32, device=device)[:97]
    idx[:3] = torch.tensor([-7, rows, 0], dtype=torch.int32, device=device)
    ok = (idx >= 0) & (idx < rows)
    # the plain version of a gather that zeroes what lies outside the table
    ref = dg.gather_reference(table, torch.where(ok, idx, 0))
    ref[~ok] = 0
    row_bytes = 2 * table[0].numel()
    for ring in dg.rings(row_bytes):
        got = dg.ring_dma_gather(table, idx, ring)
        assert torch.equal(got, ref), ring
    x, w = probes.chain_inputs(gen, n, 256, 2, device)
    for ring in dg.rings(row_bytes, overlap=True)[::3]:
        got, act = dg.ring_dma_gather(table, idx, ring, ws=w, x=x,
                                      overlap=True)
        assert torch.equal(got, ref), ring
        assert torch.equal(act, dg.ring_dma_gather(
            table, idx.clamp(0, rows - 1), ring, ws=w, x=x, overlap=True)[1])


@pytest.mark.parametrize("n,ring", [(1024 + 100, 32), (2048, 1), (300, 8)])
def test_gather_overlap_kernel_matches_plain(device, n, ring):
    from fenerf_tpu_torch.ops import dma_gather as dg
    from fenerf_tpu_torch.ops import mxu_chain as mc
    from fenerf_tpu_torch.ops import probes

    gen = torch.Generator(device=device).manual_seed(10)
    table = torch.randn(3000, 8, 128, generator=gen, device=device,
                        dtype=torch.bfloat16)
    idx = torch.randint(0, 3000, (n,), generator=gen, device=device,
                        dtype=torch.int32)
    x, w = probes.chain_inputs(gen, n, 256, 11, device)
    rows, act = dg.ring_dma_gather(table, idx, ring, ws=w, x=x, overlap=True)
    ref = mc.chain_reference(x, w)
    torch.cuda.synchronize()
    assert torch.equal(rows, dg.gather_reference(table, idx))
    err = (act.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err.item() <= CHAIN_TOL, err.item()
    # the overlap's wmma chain (chain.cuh::run_tile) is the same from run
    # to run
    assert torch.equal(act, dg.ring_dma_gather(table, idx, ring, ws=w, x=x,
                                               overlap=True)[1])
    rows0, act0 = dg.ring_dma_gather(table, idx, ring, ws=list(w),
                                     overlap=True)
    assert torch.equal(rows0, rows) and not act0.any()


def test_probe_layouts_mirror_the_kernels(device):
    """The wrappers' shared-memory and ring arithmetic equals the
    libraries' own: the chain's and the wide chain's stages and shared
    memory, the gather's rings."""
    from fenerf_tpu_torch.ops import dma_gather as dg
    from fenerf_tpu_torch.ops import mxu_chain as mc

    lib = mc._load_library()
    for epi, code in mc._EPI.items():
        for h in (64, 128, 192, 256):
            for layers in (1, 11, 20, 30):
                if mc.chain_stages(h, layers, epi) < 1:
                    continue
                assert lib.mxu_chain_stages(h, layers, code) == \
                    mc.chain_stages(h, layers, epi)
                assert lib.mxu_chain_smem(h, layers, code) == \
                    mc.chain_smem(h, layers, epi)
    wlib = mc._load_library("mxu_wide")
    for h in range(64, 513, 64):
        assert wlib.mxu_wide_smem(h) == mc.wide_smem(h)
        assert wlib.mxu_wide_stages(h) == mc.wide_stages(h)
    glib = dg._load_library()
    for row_bytes in (48, 512, 2048, 8192):
        for overlap in (0, 1):
            got = tuple(r for r in range(1, 4097)
                        if glib.dma_gather_rw(row_bytes, r, overlap)
                        and glib.dma_gather_smem(row_bytes, r, 256, overlap)
                        <= mc.MAX_SMEM)
            assert got == dg.rings(row_bytes, bool(overlap)), row_bytes


def test_probe_wrappers_reject_bad_input(device):
    from fenerf_tpu_torch.ops import dma_gather as dg
    from fenerf_tpu_torch.ops import mxu_chain as mc

    x = torch.zeros(64, 256, device=device, dtype=torch.bfloat16)
    w = torch.zeros(2, 256, 256, device=device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="ws"):
        mc.run_chain(x, w.cpu())
    # the x tile comes in by one bulk copy: 16-byte aligned rows
    flat = torch.zeros(64 * 256 + 1, device=device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        mc.run_chain(flat[1:].view(64, 256), w)
    with pytest.raises(ValueError, match="run_wide"):
        mc.run_chain(torch.zeros(8, 512, device=device, dtype=torch.bfloat16),
                     torch.zeros(1, 512, 512, device=device,
                                 dtype=torch.bfloat16))
    w512 = torch.zeros(1, 512, 512, device=device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="tile"):
        mc.run_wide(torch.zeros(8, 512, device=device, dtype=torch.bfloat16),
                    w512, 32)
    flat = torch.zeros(8 * 512 + 1, device=device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        mc.run_wide(flat[1:].view(8, 512), w512)
    table = torch.zeros(10, 8, 128, device=device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="idx"):
        dg.ring_dma_gather(table, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="ring"):
        dg.ring_dma_gather(table, torch.zeros(4, dtype=torch.int32,
                                              device=device), ring=128)


# ---------------------------------------------------------------------------
# the editing workflow's mask half: BiSeNet and the HD heads (cuDNN, TF32
# off) on the card against the CPU; the HD sheet's field on the kernel
# ---------------------------------------------------------------------------

# f32 convolutions with TF32 off on both sides, in another order; relative
# to each image's largest value
CONV_TOL = 1e-4


def test_bisenet_card_matches_cpu(device):
    from fenerf_tpu_torch.nn import bisenet as bn

    sd = bn.stand_in_state_dict(0)
    x = torch.randn(2, 3, 128, 128, generator=torch.Generator().manual_seed(1))
    ref = bn.bisenet_apply(bn.bisenet_from_torch(sd), x)
    out = bn.bisenet_apply(bn.bisenet_from_torch(sd, device), x.to(device))
    scale = ref.abs().amax(dim=(1, 2, 3), keepdim=True)
    err = ((out.cpu() - ref).abs() / scale).max().item()
    assert err <= CONV_TOL, err


def test_neural_renderer_card_matches_cpu(device):
    from fenerf_tpu_torch.compat.jax_bridge import tree_map
    from fenerf_tpu_torch.nn import neural_renderer as nr

    g = torch.Generator().manual_seed(2)
    for kw in (dict(n_feat=64, input_dim=64, img_size=256, input_size=64),
               dict(n_feat=64, input_dim=64, img_size=128, input_size=32,
                    out_dim=19, final_actvn=False, upsample_feat="bilinear",
                    use_norm=True)):
        cfg = nr.NeuralRendererConfig(**kw)
        params = nr.init_neural_renderer(g, cfg)
        x = torch.rand(1, 64, cfg.input_size, cfg.input_size, generator=g)
        ref = nr.apply_neural_renderer(params, cfg, x)
        out = nr.apply_neural_renderer(
            tree_map(lambda t: t.to(device), params), cfg, x.to(device))
        err = ((out.cpu() - ref).abs().max() / ref.abs().max()).item()
        assert err <= CONV_TOL, (kw, err)


def test_hd_sheet_field_on_the_kernel(device):
    """One HD view's features (SPATIALSIRENSEMANTICHD at full width, 32^2,
    24 + 24 steps): the field kernel against the field's torch route at
    bf16, and the heads' output."""
    import math

    from fenerf_tpu_torch.models import generator as gen
    from fenerf_tpu_torch.nn import neural_renderer as nr

    cfg = fields.get_config("SPATIALSIRENSEMANTICHD")
    g = torch.Generator(device=device).manual_seed(0)
    params = fields.init_field(g, cfg, device=device)
    params["sigma_head"]["b"] = params["sigma_head"]["b"] + 5.0
    heads = []
    for out_dim, act in ((3, True), (19, False)):
        ncfg = nr.NeuralRendererConfig(n_feat=64, input_dim=64,
                                       out_dim=out_dim, final_actvn=act,
                                       img_size=128, input_size=32)
        heads += [tree_map(lambda t: t.to(device), nr.init_neural_renderer(
            torch.Generator().manual_seed(out_dim), ncfg)), ncfg]
    zg = torch.randn(1, cfg.z_geo_dim, generator=g, device=device)
    fg, fa = fields.field_film(params, cfg, zg, zg)
    pix = {}
    for backend in ("kernel", "torch"):
        rcfg = gen.RenderConfig(img_size=32, num_steps=48, fill_mode=None,
                                compute_dtype="bfloat16", backend=backend)
        launches = ops.film_mlp.launches
        with torch.no_grad():
            pix[backend] = gen.render_hd(
                params, cfg, rcfg, fg, fa, 1, *heads,
                camera=(math.pi / 2, math.pi / 2, 12.0),
                generator=torch.Generator(device=device).manual_seed(0))[
                    "pixels"]
        assert (ops.film_mlp.launches > launches) == (backend == "kernel")
    assert pix["kernel"].shape == (1, 22, 128, 128)
    err = (pix["kernel"] - pix["torch"]).abs().max().item()
    assert err <= TOL, err
