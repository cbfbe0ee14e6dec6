"""The hand-written CUDA kernels (fenerf_tpu_torch/ops/csrc/film_mlp.cu,
film_mlp_bwd.cu, ray_finalize.cu, zexp_fold.cu) against their plain torch
versions on the card, and their wrappers' input checks. Skips without an
NVIDIA GPU.

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
    (FLAGSHIP, dict(grid_resolution=16), 3, 1001),         # ragged tiles
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
    (FLAGSHIP, dict(grid_resolution=16), 3, 1001),         # ragged tiles
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


@pytest.mark.parametrize("b,r,s", [(1, 64, 12), (3, 1001, 48), (2, 37, 5)])
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


@pytest.mark.parametrize("b,r,sf,sc,c1", [(2, 33, 8, 8, 5),
                                          (1, 1001, 48, 48, 22),
                                          (3, 129, 24, 24, 22)])
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
