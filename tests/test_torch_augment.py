"""The trainer's DiffAugment and gradient subset of rays against
fenerf_tpu, with the JAX package's draws replayed: diff_augment for each
policy, a grad_rays = 0.5 render (its pixels against the grad_rays = 1
render, its parameter gradients against jax.grad with the same ray
permutation; tests/test_torch_train_step_aug.py holds a whole train_step
with both on). CPU sizes: hidden 32, z 8, 8^2-16^2 images, 6 steps per
ray.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fenerf_tpu.models import generator as jgen
from fenerf_tpu.nn import fields as jfields
from fenerf_tpu.train import diff_augment as jaug
from fenerf_tpu_torch.compat.jax_bridge import from_numpy_tree, tree_leaves
from fenerf_tpu_torch.models import generator as tgen
from fenerf_tpu_torch.nn import fields as tfields
from fenerf_tpu_torch.train import diff_augment as taug

from test_torch_train_step import _jax_draws, _t

torch.set_num_threads(2)

POLICY = "color,translation,cutout"
GRAD_FOLD = 0x6AD   # fenerf_tpu/models/generator.py: the permutation's key


def jax_augment_draws(key, policy, b, h, w):
    """The draws fenerf_tpu.train.diff_augment.diff_augment makes from
    `key` (one split per transform, two inside translation and cutout),
    as the port's list."""
    out = []
    for fn in taug.policy_fns(policy):
        key, sub = jax.random.split(key)
        if fn in (taug._brightness, taug._saturation, taug._contrast):
            out.append(_t(jax.random.uniform(sub, (b, 1, 1, 1))))
            continue
        kx, ky = jax.random.split(sub)
        if fn is taug._translation:
            sh, sw = int(h * 0.125 + 0.5), int(w * 0.125 + 0.5)
            out.append((
                torch.from_numpy(np.array(jax.random.randint(
                    kx, (b,), -sh, sh + 1))).long(),
                torch.from_numpy(np.array(jax.random.randint(
                    ky, (b,), -sw, sw + 1))).long()))
        else:
            ch, cw = int(h * 0.5 + 0.5), int(w * 0.5 + 0.5)
            out.append((
                torch.from_numpy(np.array(jax.random.randint(
                    kx, (b, 1, 1), 0, h + (1 - ch % 2))).reshape(b)).long(),
                torch.from_numpy(np.array(jax.random.randint(
                    ky, (b, 1, 1), 0, w + (1 - cw % 2))).reshape(b)).long()))
    return out


def jax_perm(key, n_rays):
    return torch.from_numpy(np.asarray(jax.random.permutation(
        jax.random.fold_in(key, GRAD_FOLD), n_rays))).long()


@pytest.mark.parametrize("policy", ["color", "translation", "cutout",
                                    POLICY, "cutout,color"])
@pytest.mark.parametrize("hw", [(16, 16), (15, 13)])
def test_diff_augment_matches_jax(policy, hw):
    h, w = hw
    x = np.random.default_rng(h).uniform(-1, 1, (4, 3, h, w)).astype(
        np.float32)
    key = jax.random.key(h * 31 + len(policy))
    ref = np.asarray(jaug.diff_augment(key, jnp.asarray(x), policy))
    out = taug.diff_augment(_t(x), policy,
                            jax_augment_draws(key, policy, 4, h, w))
    # f32: the channel and image means sum in another order (ulp of 1)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_augment_draws_and_gradient():
    """The port's own draws are in range, and the augmentation passes
    gradients to its input (the G phase differentiates through it)."""
    g = torch.Generator().manual_seed(0)
    draws = taug.make_augment_draws(g, POLICY, 64, (16, 16), "cpu")
    assert len(draws) == 5
    tx, ty = draws[3]
    assert tx.abs().max() <= 2 and ty.abs().max() <= 2
    ox, oy = draws[4]
    assert 0 <= int(ox.min()) and int(ox.max()) <= 16
    x = torch.rand(64, 3, 16, 16, requires_grad=True)
    taug.diff_augment(x, POLICY, draws).sum().backward()
    assert x.grad.abs().sum() > 0
    with pytest.raises(ValueError, match="takes 5 draws"):
        taug.diff_augment(x, POLICY, draws[:2])


FLAGSHIP = "TextureEmbeddingPiGAN256SEMANTICDISENTANGLE_DIM_96"
SMALL = dict(hidden_dim=32, z_geo_dim=8, z_app_dim=8, map_hidden_dim=32,
             grid_resolution=8, grid_channels=4)


def _render_setup(chunk):
    jcfg = jfields.get_config(FLAGSHIP, **SMALL)
    tcfg = tfields.get_config(FLAGSHIP, **SMALL)
    jp = jfields.init_field(jax.random.key(0), jcfg)
    jp["sigma_head"]["b"] = jp["sigma_head"]["b"] + 5.0
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(5)
    zg = rng.standard_normal((2, 8)).astype(np.float32)
    za = rng.standard_normal((2, 8)).astype(np.float32)
    rc = dict(img_size=8, num_steps=6, hierarchical=True, ray_chunk=chunk,
              fill_mode="seg_padding_background")
    wpix = rng.standard_normal((2, jcfg.n_labels + 4, 8, 8)).astype(
        np.float32)
    return jcfg, tcfg, jp, tp, zg, za, rc, wpix


@pytest.mark.parametrize("chunk", [0, 16])
def test_grad_rays_render_and_gradient(chunk):
    jcfg, tcfg, jp, tp, zg, za, rc, wpix = _render_setup(chunk)
    key = jax.random.key(7)
    jr = jgen.RenderConfig(**rc, grad_rays=0.5)
    draws = _jax_draws(key, 2, jr, 0.5)._replace(
        ray_perm=jax_perm(key, jr.n_rays))
    tr_half = tgen.RenderConfig(**rc, grad_rays=0.5)
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    out = tgen.render_from_z(tp, tcfg, tr_half, _t(zg), _t(za),
                             noise_std=0.5, draws=draws)
    # the pixels equal the grad_rays = 1 render's on the same draws
    with torch.no_grad():
        full = tgen.render_from_z(tp, tcfg, tgen.RenderConfig(**rc), _t(zg),
                                  _t(za), noise_std=0.5, draws=draws)
    np.testing.assert_allclose(out["pixels"].detach().numpy(),
                               full["pixels"].numpy(), atol=1e-6, rtol=0)
    mask = out["grad_ray_mask"]
    q = chunk or 1
    assert int(mask.sum()) == (round(0.5 * 64) // q) * q
    # and the JAX package's
    jout = jgen.render_from_z(jp, jcfg, jr, key, jnp.asarray(zg),
                              jnp.asarray(za), noise_std=0.5)
    np.testing.assert_array_equal(mask.numpy(),
                                  np.asarray(jout["grad_ray_mask"]))
    np.testing.assert_allclose(out["pixels"].detach().numpy(),
                               np.asarray(jout["pixels"]), atol=1e-4)

    def jloss(p):
        o = jgen.render_from_z(p, jcfg, jr, key, jnp.asarray(zg),
                               jnp.asarray(za), noise_std=0.5)
        return jnp.sum(o["pixels"] * wpix)

    jg = jax.jit(jax.grad(jloss))(jp)
    tg = torch.autograd.grad((out["pixels"] * _t(wpix)).sum(), leaves)
    for (path, a), t in zip(jax.tree_util.tree_flatten_with_path(jg)[0], tg):
        a, b = np.asarray(a, np.float64), t.numpy().astype(np.float64)
        # rtol 1e-3 of the leaf's largest entry, f32 floor 1e-6
        assert np.abs(b - a).max() <= 1e-3 * np.abs(a).max() + 1e-6, \
            jax.tree_util.keystr(path)
    # rays outside the subset pass no gradient: only masked pixels move it
    w_off = _t(wpix) * (~mask).float()
    g_off = torch.autograd.grad(
        (tgen.render_from_z(tp, tcfg, tr_half, _t(zg), _t(za),
                            noise_std=0.5, draws=draws)["pixels"]
         * w_off).sum(), leaves, allow_unused=True)
    assert all(g is None or float(g.abs().max()) == 0.0 for g in g_off)
