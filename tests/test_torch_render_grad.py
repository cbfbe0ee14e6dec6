"""Port parity for the gradients around the field: the texture table's
hand adjoint, and a whole render's parameter gradient (which checks that no
gradient flows through the proposal, as in the JAX package). Small sizes:
hidden 32, z 8, grid 8^3x4.
"""
import numpy as np

import jax
import jax.numpy as jnp
import torch

from fenerf_tpu.core import grid_sample as jgs
from fenerf_tpu.models import generator as jgen
from fenerf_tpu.nn import fields as jfields
from fenerf_tpu_torch.compat.jax_bridge import from_numpy_tree, tree_leaves
from fenerf_tpu_torch.core import grid_sample as tgs
from fenerf_tpu_torch.models import generator as tgen
from fenerf_tpu_torch.nn import fields as tfields

torch.set_num_threads(2)

FLAGSHIP = "TextureEmbeddingPiGAN256SEMANTICDISENTANGLE_DIM_96"
SMALL = dict(hidden_dim=32, z_geo_dim=8, z_app_dim=8, map_hidden_dim=32)
GRID_SMALL = dict(grid_resolution=8, grid_channels=4)
def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _setup(name, b=2, n=150, **kw):
    over = {**SMALL, **kw}
    jcfg = jfields.get_config(name, **over)
    tcfg = tfields.get_config(name, **over)
    jp = jfields.init_field(jax.random.key(0), jcfg)
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(1)
    pts = (rng.standard_normal((b, n, 3)) * 0.1).astype(np.float32)
    dirs = rng.standard_normal((b, n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    zg = rng.standard_normal((b, jcfg.z_geo_dim)).astype(np.float32)
    za = rng.standard_normal((b, jcfg.z_app_dim)).astype(np.float32)
    return jcfg, tcfg, jp, tp, pts, dirs, zg, za, rng


def _jax_draws(key, b, rcfg, noise_std):
    """The draws jax render_core makes from `key` (generator.py:381,
    rays.py:170, rays.py:85), as a port RenderDraws."""
    k_rays, k_c, k_pdf, k_f = jax.random.split(key, 4)
    k_perturb, k_cam = jax.random.split(k_rays)
    jitter = jax.random.uniform(k_perturb, (b, rcfg.n_rays, rcfg.num_steps))
    k_h, k_v, _ = jax.random.split(k_cam, 3)
    noise = jgen.draw_ray_noise(k_c, k_pdf, k_f, b, rcfg.n_rays, rcfg,
                                noise_std)
    opt = lambda x: None if x is None else _t(x)
    return tgen.RenderDraws(
        jitter=_t(jitter), cam_h=_t(jax.random.normal(k_h, (b, 1))),
        cam_v=_t(jax.random.normal(k_v, (b, 1))),
        noise=tgen.RayNoise(*(opt(x) for x in noise)))


def assert_grads_match(ref, out, what, cos_min=0.999, rtol=0.02):
    """The JAX package's kernel-gradient criterion
    (tests/test_film_mlp_kernel.py): per group cosine > 0.999 and norms
    within 2%; groups whose two norms are both below 1e-8 are skipped."""
    a = np.asarray(ref, np.float64).ravel()
    b = np.asarray(out, np.float64).ravel()
    assert a.shape == b.shape, (what, a.shape, b.shape)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na < 1e-8 and nb < 1e-8:
        return
    cos = float(a @ b / max(na * nb, 1e-30))
    assert cos > cos_min, f"{what}: cos={cos}"
    assert abs(na - nb) / max(na, 1e-12) < rtol, f"{what}: {na} vs {nb}"


class TestTableAdjoint:
    def test_adjoint_matches_jax(self):
        rng = np.random.default_rng(3)
        shape = (4, 5, 6, 7)
        rows = 6 * 7 * 8
        dt = rng.standard_normal((rows, 8 * 4)).astype(np.float32)
        ref = jgs.zexp_table_adjoint_xla(jnp.asarray(dt), shape)
        out = tgs.zexp_table_adjoint(_t(dt), shape)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
        # bf16 cotangent, f32 accumulation
        dtb = jnp.asarray(dt, jnp.bfloat16)
        ref = jgs.zexp_table_adjoint_xla(dtb, shape)
        out = tgs.zexp_table_adjoint(
            torch.from_numpy(np.array(dtb.astype(jnp.float32))).to(
                torch.bfloat16), shape)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)

    def test_table_build_backward_is_the_adjoint(self):
        rng = np.random.default_rng(4)
        grid = _t(rng.standard_normal((3, 4, 5, 6))).requires_grad_(True)
        table = tgs.build_zexp_table(grid)
        w = _t(rng.standard_normal(tuple(table.shape)))
        (dgrid,) = torch.autograd.grad((table * w).sum(), grid)
        ref = jax.grad(lambda gr: jnp.sum(
            jgs.build_zexp_table(gr) * jnp.asarray(w.numpy())))(
            jnp.asarray(grid.detach().numpy()))
        np.testing.assert_allclose(dgrid.numpy(), np.asarray(ref), atol=1e-5)


class TestRenderGradient:
    def test_render_gradient_matches_jax(self):
        """A whole render's parameter gradient (torch route, f32) against
        jax.grad of the JAX render on the same draws: no gradient flows
        through the proposal (coarse weights -> sample_pdf -> fine z)."""
        jcfg, tcfg, jp, tp, *_ = _setup(FLAGSHIP, **GRID_SMALL)
        jp["sigma_head"]["b"] = jp["sigma_head"]["b"] + 5.0
        tp = from_numpy_tree(jax.tree.map(np.asarray, jp))
        rng = np.random.default_rng(5)
        zg = rng.standard_normal((2, 8)).astype(np.float32)
        za = rng.standard_normal((2, 8)).astype(np.float32)
        rc = dict(img_size=8, num_steps=6, hierarchical=True,
                  fill_mode="seg_padding_background")
        jr = jgen.RenderConfig(**rc)
        key = jax.random.key(7)
        wpix = rng.standard_normal((2, jcfg.n_labels + 4, 8, 8)).astype(
            np.float32)

        def jloss(p):
            out = jgen.render_from_z(p, jcfg, jr, key, jnp.asarray(zg),
                                     jnp.asarray(za), noise_std=0.5)
            return jnp.sum(out["pixels"] * wpix)

        jg = jax.grad(jloss)(jp)
        leaves = tree_leaves(tp)
        for t in leaves:
            t.requires_grad_(True)
        out = tgen.render_from_z(
            tp, tcfg, tgen.RenderConfig(**rc), _t(zg), _t(za),
            noise_std=0.5, draws=_jax_draws(key, 2, jr, 0.5))
        tg = torch.autograd.grad((out["pixels"] * _t(wpix)).sum(), leaves)
        for (path, a), t in zip(jax.tree_util.tree_flatten_with_path(jg)[0],
                                tg):
            assert_grads_match(a, t.numpy(), jax.tree_util.keystr(path))
