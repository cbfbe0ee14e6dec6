"""The hand-written CUDA field kernels (fenerf_tpu_torch/ops/csrc/film_mlp.cu,
film_mlp_bwd.cu) against their plain torch versions on the card. Skips
without an NVIDIA GPU.

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
