"""One whole train_step of fenerf_tpu_torch with grad_rays = 0.5 and a
DiffAugment policy on, against fenerf_tpu.train.loop.train_step on the same
parameters with the JAX step's draws replayed (test_torch_train_step's
replay plus the permutations and augmentation draws); and the port's own
draws of both. CPU sizes: bs 4, split 2, 16^2, 4 steps, hidden 16.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fenerf_tpu.train import curriculum as jcur
from fenerf_tpu.train import loop as jloop
from fenerf_tpu_torch.compat import jax_bridge
from fenerf_tpu_torch.compat.jax_bridge import tree_leaves
from fenerf_tpu_torch.train import curriculum as tcur
from fenerf_tpu_torch.train import loop as tloop

from test_torch_augment import POLICY, jax_augment_draws, jax_perm
from test_torch_train_step import (_jax_moments, _t, assert_grads_match,
                                   jax_step_draws, tiny_texture_meta)

torch.set_num_threads(2)


def jax_step_draws_aug(key, meta, b, noise_std):
    """fenerf_tpu.train.loop.train_step's draws with grad_rays and a
    DiffAugment policy: test_torch_train_step's replay plus each G
    microbatch's ray permutation (fold_in(k, 0x6AD)) and augmentation
    (fold_in(k, 77)), and D_img's augmentation from the 7th split."""
    base = jax_step_draws(key, meta, b, noise_std)
    k_fg, k_aug = jax.random.split(key, 7)[5:]
    s = 1 if meta.full_batch else meta.batch_split
    gkeys = [k_fg] if s == 1 else list(jax.random.split(k_fg, s))
    n_rays = meta.img_size ** 2
    size = (meta.img_size, meta.img_size)
    g_renders = [d._replace(ray_perm=jax_perm(k, n_rays))
                 for d, k in zip(base.g_renders, gkeys)]
    aug_g = [jax_augment_draws(jax.random.fold_in(k, 77),
                               meta.diff_augment_policy, b // s, *size)
             for k in gkeys]
    return base._replace(
        g_renders=g_renders,
        aug_d=jax_augment_draws(k_aug, meta.diff_augment_policy, b, *size),
        aug_g=aug_g)


def test_step_with_grad_rays_and_augment_matches_jax():
    """The batch_split path (split 2): D_img's augmentation of reals and
    fakes, each G microbatch's permutation and augmentation."""
    over = dict(grad_rays=0.5, diff_augment_policy=POLICY,
                betas=(0.0, 0.9))
    jmeta = tiny_texture_meta(jcur, **over)
    tmeta = tiny_texture_meta(tcur, **over)
    jstate = jloop.init_train_state(jax.random.key(0), jmeta)
    params = jax_bridge.train_params_from_numpy(
        jax.tree.map(np.asarray, jstate))
    tstate = tloop.train_state_from_params(tmeta, *params.values())
    rng = np.random.default_rng(0)
    imgs = rng.uniform(-1, 1, (4, 3, 16, 16)).astype(np.float32)
    labels = rng.uniform(-1, 1, (4, 18, 16, 16)).astype(np.float32)
    alpha, noise, topk = 0.5, 0.7, 0.75
    jscal = jloop.StepScalars(alpha=jnp.asarray(alpha),
                              noise_std=jnp.asarray(noise),
                              topk_frac=jnp.asarray(topk))
    key = jax.random.key(1)
    jnew, jm = jax.jit(jloop.train_step, static_argnums=(5,))(
        jstate, jnp.asarray(imgs), jnp.asarray(labels), key, jscal, jmeta)
    tscal = tloop.StepScalars(alpha=torch.tensor(alpha),
                              noise_std=torch.tensor(noise),
                              topk_frac=torch.tensor(topk))
    draws = jax_step_draws_aug(key, jmeta, 4, jscal.noise_std)
    tnew, tm = tloop.train_step(tstate, _t(imgs), _t(labels), tscal, tmeta,
                                draws=draws)
    for k in ("d_img_loss", "d_seg_loss", "g_loss", "g_img_loss",
              "g_seg_loss", "fake_opacity"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    for name, jopt, topt in (("g", jnew.opt_g, tnew.opt_g),
                             ("d_img", jnew.opt_img, tnew.opt_img),
                             ("d_seg", jnew.opt_seg, tnew.opt_seg)):
        jmu = _jax_moments(jopt, name == "g")
        for key_ in topt.mu:
            for i, (a, b) in enumerate(zip(jax.tree.leaves(jmu[key_]),
                                           tree_leaves(topt.mu[key_]))):
                assert_grads_match(a, b.numpy(), f"{name}/{key_}/{i}")


def test_step_draws_carry_perm_and_augment():
    meta = dataclasses.replace(tiny_texture_meta(tcur), grad_rays=0.25,
                               diff_augment_policy=POLICY)
    d = tloop.make_step_draws(torch.Generator().manual_seed(0), meta, 4,
                              0.5, "cpu")
    assert all(r.ray_perm is not None and sorted(r.ray_perm.tolist())
               == list(range(256)) for r in d.g_renders)
    assert all(r.ray_perm is None for r in d.fakes_img + d.fakes_seg)
    assert len(d.aug_d) == 5 and len(d.aug_g) == meta.batch_split
    assert d.aug_g[0][0].shape == (2, 1, 1, 1)
    with pytest.raises(ValueError, match="augmentation draws"):
        tloop.train_step(tloop.init_train_state(meta, device="cpu"),
                         torch.zeros(4, 3, 16, 16), torch.zeros(4, 18, 16, 16),
                         tloop.StepScalars(0.5, 0.5, 0.9), meta,
                         draws=d._replace(aug_d=None))
