"""The port's ray-parallel renders and sharded lattices
(models/generator.py::render_image_sharded, render_grid_sharded,
eval_volume_sharded, eval_volume_grid_sharded) and the camera modes
'hybrid' and 'truncated_gaussian' (core/rays.py), on the CPU.

A list of torch.devices stands in for the mesh; on the CPU it repeats the
CPU n times. Strips of n = 1, 2 and 4 put together equal the whole render
bit for bit (each strip a whole number of ray_chunk blocks, so the field
sees the same blocks), and slabs the whole lattice (the slab a multiple of
the chunk). Against the JAX package's sharded functions on the 8-device CPU
mesh of tests/conftest.py, on the JAX draws replayed: the render tolerances
of tests/test_torch_generator.py (1e-4) and tests/test_torch_grid_field.py
(1e-4), the lattice's of tests/test_torch_shapes.py (1e-5). The camera
modes take JAX's draws injected (1e-6). extract_shapes leaves the process's
TF32 flag as it found it.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fenerf_tpu.core import rays as jrays
from fenerf_tpu.models import generator as jgen
from fenerf_tpu.nn import fields as jfields
from fenerf_tpu.nn import latent_grid_field as jlgf
from fenerf_tpu.train import sharding as jsharding
from fenerf_tpu_torch.compat.jax_bridge import from_numpy_tree
from fenerf_tpu_torch.core import rays as trays
from fenerf_tpu_torch.models import generator as tgen
from fenerf_tpu_torch.nn import fields as tfields
from fenerf_tpu_torch.nn import latent_grid_field as tlgf

torch.set_num_threads(2)

FLAGSHIP = "TextureEmbeddingPiGAN256SEMANTICDISENTANGLE_DIM_96"
SMALL = dict(hidden_dim=16, z_geo_dim=8, z_app_dim=8, map_hidden_dim=16,
             grid_resolution=8, grid_channels=4)
GRID_KW = dict(z_dim=8, hidden_dim=16, grid_res=8, grid_ch=8, ch_max=16,
               map_hidden_dim=16)
RENDER = dict(img_size=16, num_steps=6, hierarchical=True, perturb=True,
              fill_mode="seg_padding_background", ray_chunk=64)
CAMERA = (math.pi * 0.5, math.pi * 0.5 + 0.3, 12.0)
CPU = torch.device("cpu")


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.fixture(scope="module")
def film_model():
    jcfg = jfields.get_config(FLAGSHIP, **SMALL)
    jp = jfields.init_field(jax.random.key(0), jcfg)
    jp["sigma_head"]["b"] = jp["sigma_head"]["b"] + 5.0   # non-empty
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(5)
    zg, za = (rng.standard_normal((2, 8)).astype(np.float32)
              for _ in range(2))
    jfilm = jfields.field_film(jp, jcfg, jnp.asarray(zg), jnp.asarray(za))
    tcfg = tfields.get_config(FLAGSHIP, **SMALL)
    tfilm = tfields.field_film(tp, tcfg, _t(zg), _t(za))
    return jcfg, tcfg, jp, tp, jfilm, tfilm


@pytest.fixture(scope="module")
def grid_model():
    jcfg = jlgf.get_grid_config("SPATIALSIRENGRID", **GRID_KW)
    jp = jlgf.init_grid_field(jax.random.key(0), jcfg)
    jp["sigma_head"]["b"] = jp["sigma_head"]["b"] + 5.0
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp))
    z = np.random.default_rng(6).standard_normal((2, 8)).astype(np.float32)
    return (jcfg, tlgf.get_grid_config("SPATIALSIRENGRID", **GRID_KW), jp,
            tp, z)


def _jax_draws(key, b, rcfg):
    """render_core's draws from `key` at noise_std 0 (the sharded renders'
    key structure, generator.py:557-560), as a port RenderDraws."""
    k_rays, k_c, k_pdf, k_f = jax.random.split(key, 4)
    k_perturb, _ = jax.random.split(k_rays)
    jitter = jax.random.uniform(k_perturb, (b, rcfg.n_rays, rcfg.num_steps))
    noise = jgen.draw_ray_noise(k_c, k_pdf, k_f, b, rcfg.n_rays, rcfg, 0.0)
    return tgen.RenderDraws(_t(jitter), None, None, tgen.RayNoise(
        _t(noise.u), None, None))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_film_strips_equal_the_whole_render(film_model, n):
    _, tcfg, _, tp, _, (fg, fa) = film_model
    rcfg = tgen.RenderConfig(**RENDER)
    g = lambda: torch.Generator().manual_seed(4)
    whole = tgen.render(tp, tcfg, rcfg, fg, fa, 2, noise_std=0.5,
                        camera=CAMERA, generator=g())
    pix, depth = tgen.render_image_sharded(
        tp, tcfg, rcfg, fg, fa, [CPU] * n, CAMERA, batch_size=2,
        noise_std=0.5, return_depth=True, generator=g())
    assert torch.equal(pix, whole["pixels"])
    assert torch.equal(depth, whole["depth"])


@pytest.mark.parametrize("n", [1, 2, 4])
def test_grid_strips_equal_the_whole_render(grid_model, n):
    _, tcfg, _, tp, z = grid_model
    rcfg = tgen.RenderConfig(**dict(RENDER, fill_mode="eval_white_back"))
    g = lambda: torch.Generator().manual_seed(4)
    whole = tgen.render_grid_from_z(tp, tcfg, rcfg, _t(z), camera=CAMERA,
                                    generator=g())
    pix = tgen.render_grid_sharded(tp, tcfg, rcfg, _t(z), [CPU] * n,
                                   CAMERA, generator=g())
    assert torch.equal(pix, whole["pixels"])


def test_strips_must_divide_the_rows(film_model):
    _, tcfg, _, tp, _, (fg, fa) = film_model
    with pytest.raises(ValueError, match="not divisible into 3 strips"):
        tgen.render_image_sharded(tp, tcfg, tgen.RenderConfig(**RENDER),
                                  fg, fa, [CPU] * 3, CAMERA, batch_size=2)


def test_film_strips_match_jax_mesh(film_model):
    jcfg, tcfg, jp, tp, jfilm, tfilm = film_model
    mesh = jsharding.data_mesh(jax.devices()[:4])
    jr = jgen.RenderConfig(**RENDER)
    key = jax.random.key(7)
    ref = jax.jit(lambda p, f: jgen.render_image_sharded(
        p, jcfg, jr, key, *f, mesh, CAMERA, batch_size=2, noise_std=0.0,
        return_depth=True))(jp, jfilm)
    out = tgen.render_image_sharded(tp, tcfg, tgen.RenderConfig(**RENDER),
                                    *tfilm, [CPU] * 4, CAMERA, batch_size=2,
                                    return_depth=True,
                                    draws=_jax_draws(key, 2, jr))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)


def test_grid_strips_match_jax_mesh(grid_model):
    jcfg, tcfg, jp, tp, z = grid_model
    mesh = jsharding.data_mesh(jax.devices()[:4])
    rc = dict(RENDER, fill_mode="eval_white_back")
    jr = jgen.RenderConfig(**rc)
    key = jax.random.key(3)
    ref = jax.jit(lambda p, z: jgen.render_grid_sharded(
        p, jcfg, jr, key, z, mesh, CAMERA, return_depth=True))(
            jp, jnp.asarray(z))
    out = tgen.render_grid_sharded(tp, tcfg, tgen.RenderConfig(**rc), _t(z),
                                   [CPU] * 4, CAMERA, return_depth=True,
                                   draws=_jax_draws(key, 2, jr))
    assert float(np.asarray(ref[1]).std()) > 0
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_volume_slabs_equal_the_whole_lattice(film_model, grid_model, n):
    _, tcfg, _, tp, _, (fg, fa) = film_model
    pts = tgen.voxel_points(16, 0.3)          # 4096 points, blocks of 256
    one = lambda f: tuple(t[:1] for t in f)
    whole = tgen.eval_volume(tp, tcfg, one(fg), one(fa), pts, chunk=256)
    out = tgen.eval_volume_sharded(tp, tcfg, one(fg), one(fa), pts,
                                   [CPU] * n, chunk=256)
    assert torch.equal(out, whole)
    _, gcfg, _, gp, z = grid_model
    whole = tgen.eval_volume_grid(gp, gcfg, _t(z[:1]), pts, chunk=256)
    out = tgen.eval_volume_grid_sharded(gp, gcfg, _t(z[:1]), pts,
                                        [CPU] * n, chunk=256)
    assert torch.equal(out, whole)


def test_volume_slabs_match_jax_mesh(film_model, grid_model):
    """Both families, 4 slabs, a lattice that pads (1000 points)."""
    jcfg, tcfg, jp, tp, jfilm, tfilm = film_model
    mesh = jsharding.data_mesh(jax.devices()[:4])
    one = lambda f: tuple(t[:1] for t in f)
    jpts = jgen.voxel_points(10, 0.3)
    ref = jax.jit(lambda p, f: jgen.eval_volume_sharded(
        p, jcfg, *(one(x) for x in f), jpts, mesh, chunk=128))(jp, jfilm)
    out = tgen.eval_volume_sharded(tp, tcfg, *(one(f) for f in tfilm),
                                   tgen.voxel_points(10, 0.3), [CPU] * 4,
                                   chunk=128)
    assert out.shape == ref.shape == (1000, tcfg.output_dim)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    gj, gt, gjp, gtp, z = grid_model
    ref = jax.jit(lambda p, z: jgen.eval_volume_grid_sharded(
        p, gj, z, jpts, mesh, chunk=128))(gjp, jnp.asarray(z[:1]))
    out = tgen.eval_volume_grid_sharded(gtp, gt, _t(z[:1]),
                                        tgen.voxel_points(10, 0.3),
                                        [CPU] * 4, chunk=128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


# ---------------------------------------------------------------------------
# the camera modes 'hybrid' and 'truncated_gaussian'
# ---------------------------------------------------------------------------

CAM = dict(h_stddev=0.3, v_stddev=0.155, h_mean=math.pi / 2,
           v_mean=math.pi / 2)


def _jax_camera_draws(key, mode, n):
    """sample_camera's draws for `mode` (rays.py:80-108), as the port's
    (cam_h, cam_v, cam_coin)."""
    k_h, k_v, k_mix = jax.random.split(key, 3)
    shape = (n, 1)
    if mode == "truncated_gaussian":
        return (_t(jax.random.truncated_normal(k_h, -2.0, 2.0, shape)),
                _t(jax.random.truncated_normal(k_v, -2.0, 2.0, shape)),
                None)
    ku1, ku2 = jax.random.split(k_mix)
    cam_h = np.concatenate([jax.random.normal(k_h, shape),
                            jax.random.uniform(ku1, shape)], axis=1)
    cam_v = np.concatenate([jax.random.normal(k_v, shape),
                            jax.random.uniform(ku2, shape)], axis=1)
    coin = bool(jax.random.bernoulli(jax.random.fold_in(k_mix, 1)))
    return _t(cam_h), _t(cam_v), torch.tensor(coin)


@pytest.mark.parametrize("mode,seed", [("hybrid", 0), ("hybrid", 1),
                                       ("hybrid", 2), ("hybrid", 3),
                                       ("truncated_gaussian", 0)])
def test_camera_modes_match_jax(mode, seed):
    key = jax.random.key(seed)
    ref = jrays.sample_camera(key, 5, mode=mode, **CAM)
    cam_h, cam_v, coin = _jax_camera_draws(key, mode, 5)
    out = trays.sample_camera(5, mode=mode, cam_h=cam_h, cam_v=cam_v,
                              cam_coin=coin, **CAM)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=0)


def test_camera_mode_draws():
    """The draws of each mode: hybrid's normal and uniform columns and one
    coin for the batch; truncated normals inside [-2, 2]; a render in each
    mode; an unknown mode draws nothing and gives the mean pose."""
    rcfg = tgen.RenderConfig(img_size=8, num_steps=4, hierarchical=False)
    g = torch.Generator().manual_seed(0)
    d = tgen.draw_render(g, 4096, rcfg, 0.0, "hybrid")
    assert d.cam_h.shape == d.cam_v.shape == (4096, 2)
    assert d.cam_coin.shape == () and d.cam_coin.dtype == torch.bool
    u = d.cam_h[:, 1]
    assert 0 <= float(u.min()) and float(u.max()) < 1
    assert float(d.cam_h[:, 0].min()) < -2.5      # untruncated normals
    d = tgen.draw_render(g, 4096, rcfg, 0.0, "truncated_gaussian")
    x = d.cam_h[:, 0]
    assert -2 <= float(x.min()) < -1.9 and 1.9 < float(x.max()) <= 2
    assert abs(float(x.mean())) < 0.05 and 0.8 < float(x.std()) < 0.9
    for mode in ("hybrid", "truncated_gaussian"):
        out = tgen.render_core(lambda p, r: torch.ones(p.shape[:2] + (4,)),
                               4, tgen.RenderConfig(
                                   img_size=8, num_steps=4,
                                   hierarchical=False, sample_dist=mode),
                               3, generator=torch.Generator().manual_seed(1))
        assert out["position"].shape == (3, 2)
        assert torch.isfinite(out["pixels"]).all()
    # an unknown mode draws nothing and takes the mean pose
    d = tgen.draw_render(g, 2, rcfg, 0.0, "spiral")
    assert d.cam_h is None and d.cam_v is None and d.cam_coin is None
    for a, b in zip(trays.sample_camera(2, mode="spiral", **CAM),
                    trays.sample_camera(2, mode=None, **CAM)):
        assert torch.equal(a, b)


def test_extract_shapes_leaves_tf32_flag(tmp_path):
    """The lattice runs with TF32 off inside utils/precision.py::
    exact_matmuls; the process's flag is as it was after main()."""
    from fenerf_tpu_torch.apps import common as tcommon
    from fenerf_tpu_torch.apps.extract_shapes import main

    cfg = tfields.get_config(FLAGSHIP, **SMALL)
    p = tfields.init_field(torch.Generator().manual_seed(0), cfg)
    ckpt = str(tmp_path / "g.npz")
    tcommon.save_generator(ckpt, p, p, p, FLAGSHIP, 1, field_kwargs=SMALL)
    matmul = torch.backends.cuda.matmul
    kept = matmul.allow_tf32
    try:
        for flag in (True, False):
            matmul.allow_tf32 = flag
            main(["--ckpt", ckpt, "--voxel_resolution", "8", "--device",
                  "cpu", "--output_dir", str(tmp_path / "s")])
            assert matmul.allow_tf32 is flag
    finally:
        matmul.allow_tf32 = kept
