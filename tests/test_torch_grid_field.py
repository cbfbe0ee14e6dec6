"""Port parity for the latent-grid family (SPATIALSIRENGRID): the StyleGAN2
resampling ops and layers, the bilinear plane sampler, the grid field, the
grid renders, the grid checkpoint in both directions and the family
dispatch, each against the JAX package's function (jitted) on numpy-seeded
inputs. Tiny sizes: tests/test_latent_grid_e2e.py's TINY_KW (z 8, hidden
16, grid 8, ch_max 16)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fenerf_tpu.apps import common as jcommon
from fenerf_tpu.core.grid_sample import grid_sample_2d as jgs2d
from fenerf_tpu.models import generator as jgen
from fenerf_tpu.nn import latent_grid_field as jlgf
from fenerf_tpu.nn import stylegan as jsg
from fenerf_tpu.ops import upfirdn2d as jup
from fenerf_tpu_torch.apps import common as tcommon
from fenerf_tpu_torch.compat import jax_bridge
from fenerf_tpu_torch.core.grid_sample import grid_sample_2d as tgs2d
from fenerf_tpu_torch.models import generator as tgen
from fenerf_tpu_torch.nn import latent_grid_field as tlgf
from fenerf_tpu_torch.nn import stylegan as tsg
from fenerf_tpu_torch.ops import upfirdn2d as tup

torch.set_num_threads(2)

GRID = "SPATIALSIRENGRID"
TINY_KW = dict(z_dim=8, hidden_dim=16, grid_res=8, grid_ch=8, ch_max=16,
               map_hidden_dim=16)
RTOL = 1e-5     # f32 ops: the same sums, XLA's and torch's order
BF16_TOL = 2e-2  # bf16 FiLM operands, as the repo's kernel tests


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(t, a, rtol=RTOL, atol=None):
    a = np.asarray(a, dtype=np.float32)
    if atol is None:   # relative to the output's scale
        atol = rtol * float(np.abs(a).max())
    np.testing.assert_allclose(t.detach().numpy(), a, rtol=rtol, atol=atol)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def grid_model():
    """Tiny grid parameters from jax.random (sigma bias +5: an opaque
    volume) and the same tree in torch."""
    jcfg = jlgf.get_grid_config(GRID, **TINY_KW)
    jp = jlgf.init_grid_field(jax.random.key(0), jcfg)
    jp["sigma_head"]["b"] = jp["sigma_head"]["b"] + 5.0
    tp = jax_bridge.from_numpy_tree(jax.tree.map(np.asarray, jp))
    return jcfg, tlgf.get_grid_config(GRID, **TINY_KW), jp, tp


# ---------------------------------------------------------------------------
# ops/upfirdn2d.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 6), (2, 3, 5, 4)])
def test_fused_leaky_relu(shape):
    x, b = _x(shape), _x(shape[1], 1)
    ref = jax.jit(jup.fused_leaky_relu)(jnp.asarray(x), jnp.asarray(b))
    _close(tup.fused_leaky_relu(_t(x), _t(b)), ref)


@pytest.mark.parametrize("op,kw", [
    ("upsample2d", {}), ("downsample2d", {}), ("blur", {"pad": (2, 1)}),
    ("upfirdn2d", {"up": 2, "down": 1, "pad": (1, 2)}),
    ("upfirdn2d", {"up": 1, "down": 2, "pad": (0, 3)})])
def test_upfirdn2d(op, kw):
    x = _x((2, 3, 7, 6))
    if op == "upfirdn2d":
        k = np.random.default_rng(2).random((3, 4)).astype(np.float32)
        ref = jax.jit(lambda a, k: jup.upfirdn2d(a, k, **kw))(
            jnp.asarray(x), jnp.asarray(k))
        out = tup.upfirdn2d(_t(x), _t(k), **kw)
    else:
        ref = jax.jit(lambda a: getattr(jup, op)(a, **kw))(jnp.asarray(x))
        out = getattr(tup, op)(_t(x), **kw)
    assert tuple(out.shape) == ref.shape
    _close(out, ref)


def test_negative_pad_raises():
    with pytest.raises(NotImplementedError, match="negative"):
        tup.upfirdn2d(torch.zeros(1, 1, 4, 4), torch.ones(2, 2), pad=(-1, 0))


# ---------------------------------------------------------------------------
# nn/stylegan.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"demodulate": False}, {"upsample": True},
    {"upsample": True, "demodulate": False}, {"downsample": True},
    {"downsample": True, "demodulate": False},
    {"activate": False, "demodulate": False},
    {"activate": False, "bias": False}])
@pytest.mark.parametrize("ksize", [3, 1])
def test_modulated_conv2d(kw, ksize):
    """The upsampling branch is lax.conv_transpose(transpose_kernel=True)
    in JAX and conv_transpose2d in torch: the flip and the layout show
    here first (a random kernel is not symmetric)."""
    jp = jsg.init_modulated_conv(jax.random.key(ksize), 3, 5, ksize, 4)
    jp["b"] = jnp.asarray(_x(5, 7))
    tp = jax_bridge.from_numpy_tree(jax.tree.map(np.asarray, jp))
    x, z = _x((2, 3, 6, 6)), _x((2, 4), 1)
    ref = jax.jit(lambda p, a, z: jsg.modulated_conv2d(p, a, z, **kw))(
        jp, jnp.asarray(x), jnp.asarray(z))
    out = tsg.modulated_conv2d(tp, _t(x), _t(z), **kw)
    assert tuple(out.shape) == ref.shape
    _close(out, ref)


@pytest.mark.parametrize("skip_conn", [False, True])
def test_style_generator_2d(skip_conn):
    jp = jsg.init_style_generator_2d(jax.random.key(3), out_res=16, out_ch=8,
                                     z_dim=8, ch_max=16, skip_conn=skip_conn)
    tp = jax_bridge.from_numpy_tree(jax.tree.map(np.asarray, jp))
    z = _x((2, 8))
    ref = jax.jit(lambda p, z: jsg.style_generator_2d(p, z, skip_conn))(
        jp, jnp.asarray(z))
    out = tsg.style_generator_2d(tp, _t(z), skip_conn)
    assert tuple(out.shape) == ref.shape == (2, 8, 16, 16)
    _close(out, ref)
    # the port's own init draws the same tree (shapes, leaf order)
    tm = tsg.init_style_generator_2d(torch.Generator(), out_res=16, out_ch=8,
                                     z_dim=8, ch_max=16, skip_conn=skip_conn,
                                     device="meta")
    assert [tuple(x.shape) for x in jax_bridge.tree_leaves(tm)] == \
        [x.shape for x in jax.tree_util.tree_leaves(jp)]


# ---------------------------------------------------------------------------
# core/grid_sample.py::grid_sample_2d and the field's pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("span", [0.9, 1.4])
def test_grid_sample_2d(span):
    """Inside [-1, 1] and past it (zero padding), against the JAX sum in
    its own order."""
    g = _x((4, 5, 7))
    c = np.random.default_rng(1).uniform(-span, span, (3, 11, 2)).astype(
        np.float32)
    ref = jax.jit(jgs2d)(jnp.asarray(g), jnp.asarray(c))
    _close(tgs2d(_t(g), _t(c)), ref, rtol=0, atol=1e-6)


def test_local_coordinates_half_cells_exact():
    """Points on exact half-cells, where round(c - 0.5) meets a tie: the
    port rounds half to even, as jnp.round (T2)."""
    n = 8
    # c = (g + 1) / 2 * n hits every multiple of 0.5 in [0, n]
    g = (np.arange(0, 2 * n + 1, dtype=np.float32) / n - 1.0)
    pts = np.stack([g, g[::-1], np.roll(g, 3)], -1)
    ref = jax.jit(jlgf.local_coordinates, static_argnums=1)(
        jnp.asarray(pts), n)
    out = tlgf.local_coordinates(_t(pts), n)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_grid_field(grid_model, dtype):
    jcfg, tcfg, jp, tp = grid_model
    rng = np.random.default_rng(4)
    pts = rng.uniform(-0.15, 0.15, (2, 60, 3)).astype(np.float32)
    drs = rng.standard_normal((2, 60, 3)).astype(np.float32)
    z = _x((2, 8), 5)
    ref = jax.jit(lambda p, a, d, z: jlgf.apply_grid_field(
        p, jcfg, a, d, z, compute_dtype=getattr(jnp, dtype)))(
        jp, jnp.asarray(pts), jnp.asarray(drs), jnp.asarray(z))
    plane = tlgf.compute_plane(tp, tcfg, _t(z))
    out = tlgf.apply_grid_field(tp, tcfg, _t(pts), _t(drs), _t(z),
                                compute_dtype=getattr(torch, dtype),
                                plane=plane)
    assert tuple(out.shape) == (2, 60, 4)
    if dtype == "float32":
        _close(out, ref)
    else:
        _close(out, ref, rtol=0, atol=BF16_TOL)


# ---------------------------------------------------------------------------
# renders, checkpoints, dispatch
# ---------------------------------------------------------------------------

def _jax_draws(key, b, rcfg):
    """The draws JAX render_core takes from `key` at noise_std 0, as a port
    RenderDraws (the camera's are not read under a fixed camera)."""
    k_rays, k_c, k_pdf, k_f = jax.random.split(key, 4)
    k_perturb, _ = jax.random.split(k_rays)
    jitter = jax.random.uniform(k_perturb, (b, rcfg.n_rays, rcfg.num_steps))
    noise = jgen.draw_ray_noise(k_c, k_pdf, k_f, b, rcfg.n_rays, rcfg, 0.0)
    return tgen.RenderDraws(_t(jitter), None, None, tgen.RayNoise(
        _t(noise.u), None, None))


RENDER = dict(img_size=8, num_steps=6, hierarchical=True, perturb=True,
              fill_mode="eval_white_back")
CAMERA = (1.5, 1.7, 12.0)


def test_render_grid_matches_jax(grid_model):
    """render_grid_from_z at f32 on replayed draws, and render_any's grid
    branch (z_app unread)."""
    jcfg, tcfg, jp, tp = grid_model
    z = _x((2, 8), 6)
    jr = jgen.RenderConfig(**RENDER)
    key = jax.random.key(3)
    ref = jax.jit(lambda p, z: jgen.render_grid_from_z(
        p, jcfg, jr, key, z, camera=CAMERA))(jp, jnp.asarray(z))
    assert float(np.asarray(ref["opacity"]).mean()) > 0.5   # non-empty
    draws = _jax_draws(key, 2, jr)
    tr = tgen.RenderConfig(**RENDER)
    out = tgen.render_grid_from_z(tp, tcfg, tr, _t(z), camera=CAMERA,
                                  draws=draws)
    for k in ("pixels", "depth", "opacity"):
        _close(out[k], ref[k], rtol=0, atol=1e-4)
    anyr = tgen.render_any(tp, tcfg, tr, _t(z), None, camera=CAMERA,
                           draws=draws)
    torch.testing.assert_close(anyr["pixels"], out["pixels"], rtol=0,
                               atol=0)


def test_grid_render_reaches_the_ray_kernels(grid_model, monkeypatch):
    """Under FENERF_RAY_KERNELS=auto the grid family's backend 'kernel'
    opens the ray-kernel route on CUDA (its field stays torch); on the CPU
    the kernel route's plain versions give the torch route's render."""
    _, tcfg, _, tp = grid_model
    monkeypatch.setenv("FENERF_RAY_KERNELS", "auto")
    tr = tgen.RenderConfig(**RENDER, backend="kernel")
    assert tgen.ray_route(tr, "cuda")[0] == "kernels"
    assert tgen.ray_route(tr, "cpu")[0] == "torch"
    assert tcommon.best_backend(tcfg, "cuda") == "kernel"
    assert tcommon.best_backend(tcfg, "cpu") == "torch"
    # the apps' route line names the grid field's own route, not 'kernel'
    assert tcommon.route_line(tcfg, tr, "cuda").startswith(
        "field torch, rays kernels (")
    assert tcommon.route_line(tcfg, tr, "cpu").startswith(
        "field torch, rays torch (")
    z = _x((1, 8), 8)
    g = lambda: torch.Generator().manual_seed(2)
    ref = tgen.render_grid_from_z(tp, tcfg, tr, _t(z), camera=CAMERA,
                                  generator=g())
    from fenerf_tpu_torch.ops import ray_finalize as rf

    calls = rf.ray_finalize_reference.calls
    monkeypatch.setattr(tgen, "ray_route", lambda *a: ("kernels", "test"))
    out = tgen.render_grid_from_z(tp, tcfg, tr, _t(z), camera=CAMERA,
                                  generator=g())
    assert rf.ray_finalize_reference.calls == calls + 1
    torch.testing.assert_close(out["pixels"], ref["pixels"], rtol=0,
                               atol=1e-4)


def test_eval_volume_grid_matches_jax(grid_model):
    jcfg, tcfg, jp, tp = grid_model
    pts = np.random.default_rng(9).uniform(-0.15, 0.15, (300, 3)).astype(
        np.float32)
    z = _x((1, 8), 10)
    ref = jax.jit(lambda p, z, a: jgen.eval_volume_grid(
        p, jcfg, z, a, chunk=128))(jp, jnp.asarray(z), jnp.asarray(pts))
    out = tgen.eval_volume_grid(tp, tcfg, _t(z), _t(pts), chunk=128)
    assert tuple(out.shape) == (300, 4)
    _close(out, ref)


def test_dispatch_and_meta_template():
    cfg = tgen.get_any_config(GRID, z_geo_dim=12)
    assert tgen.is_grid_config(cfg) and cfg.z_dim == 12
    assert cfg == tlgf.get_grid_config(GRID, z_dim=12)
    assert not tgen.is_grid_config(tgen.get_any_config(
        "SIRENBASELINESEMANTICDISENTANGLE"))
    tm = tgen.init_any_field(torch.Generator(), cfg, device="meta")
    assert all(x.device.type == "meta" for x in jax_bridge.tree_leaves(tm))


def test_grid_leaf_order_is_jax_tree_util_order(grid_model):
    """Keys sort as color, color_head, map, sigma_head, style_gen, trunk;
    inside style_gen conv1 before convs (T4)."""
    jcfg, tcfg, jp, tp = grid_model
    assert list(sorted(tp)) == ["color", "color_head", "map", "sigma_head",
                                "style_gen", "trunk"]
    assert sorted(tp["style_gen"])[:2] == ["conv1", "convs"]
    for a, t in zip(jax.tree_util.tree_leaves(jp),
                    jax_bridge.tree_leaves(tp), strict=True):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    tm = tlgf.init_grid_field(torch.Generator(), tcfg, device="meta")
    assert [tuple(x.shape) for x in jax_bridge.tree_leaves(tm)] == \
        [x.shape for x in jax.tree_util.tree_leaves(jp)]


def _render_pair(jp, tp, jcfg, tcfg):
    """The same deterministic grid render in both packages."""
    rc = dict(img_size=8, num_steps=4, perturb=False, hierarchical=False,
              fill_mode="eval_white_back")
    z = np.linspace(-1, 1, 8, dtype=np.float32)[None]
    ref = jax.jit(lambda p, z: jgen.render_grid_from_z(
        p, jcfg, jgen.RenderConfig(**rc), jax.random.key(1), z,
        camera=CAMERA))(jp, jnp.asarray(z))
    out = tgen.render_grid_from_z(tp, tcfg, tgen.RenderConfig(**rc), _t(z),
                                  camera=CAMERA)
    return np.asarray(ref["pixels"]), out["pixels"].numpy()


def test_jax_grid_checkpoint_loads_and_renders_in_port(grid_model, tmp_path):
    jcfg, _, jp, _ = grid_model
    path = str(tmp_path / "g.npz")
    jcommon.save_generator(path, jp, jp, jp, GRID, step=5,
                           field_kwargs=TINY_KW)
    params, _, ema2, tcfg, config = tcommon.load_generator(path, device="cpu")
    assert config["family"] == "grid" and config["step"] == 5
    assert tcfg == tlgf.get_grid_config(GRID, **TINY_KW)
    for a, t in zip(jax.tree_util.tree_leaves(jp),
                    jax_bridge.tree_leaves(ema2), strict=True):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    ref, out = _render_pair(jp, params, jcfg, tcfg)
    assert np.ptp(ref) > 0.02     # not a blank image
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_port_grid_checkpoint_loads_and_renders_in_jax(tmp_path):
    tcfg = tlgf.get_grid_config(GRID, **TINY_KW)
    tp = tlgf.init_grid_field(torch.Generator().manual_seed(3), tcfg)
    tp["sigma_head"]["b"] = tp["sigma_head"]["b"] + 5.0
    path = str(tmp_path / "g.npz")
    tcommon.save_generator(path, tp, tp, tp, GRID, step=9,
                           field_kwargs=TINY_KW)
    jp, _, _, jcfg, config = jcommon.load_generator(path)
    assert config["family"] == "grid" and config["step"] == 9
    assert isinstance(jcfg, jlgf.GridFieldConfig)
    for a, t in zip(jax.tree_util.tree_leaves(jp),
                    jax_bridge.tree_leaves(tp), strict=True):
        np.testing.assert_array_equal(np.asarray(a), t.numpy())
    ref, out = _render_pair(jp, tp, jcfg, tcfg)
    np.testing.assert_allclose(out, ref, atol=1e-4)
