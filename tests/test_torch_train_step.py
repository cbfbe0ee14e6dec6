"""Port parity for one whole train_step of fenerf_tpu_torch against
fenerf_tpu.train.loop.train_step, on the same parameters (carried over by
compat/jax_bridge.py) and the JAX step's own random draws replayed, for the
batch_split loop and for full_batch. CPU sizes: bs 4, split 2, 16^2,
4 steps, hidden 16, grid 8^3x8.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from fenerf_tpu.models import generator as jgen
from fenerf_tpu.train import curriculum as jcur
from fenerf_tpu.train import loop as jloop
from fenerf_tpu_torch.compat import jax_bridge
from fenerf_tpu_torch.compat.jax_bridge import tree_leaves
from fenerf_tpu_torch.models import generator as tgen
from fenerf_tpu_torch.train import curriculum as tcur
from fenerf_tpu_torch.train import loop as tloop

torch.set_num_threads(2)

TEXTURE = "CelebA_double_semantic_texture_embedding_256_dim_96"
TINY = dict(batch_size=4, batch_split=2, img_size=16, num_steps=4,
            latent_geo_dim=8, latent_app_dim=8,
            field_overrides=(("hidden_dim", 16), ("map_hidden_dim", 16),
                             ("grid_resolution", 8), ("grid_channels", 8)))


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def tiny_texture_meta(cur, **overrides):
    """tests/test_train_step.py::tiny_texture_meta, for either package."""
    meta = cur.CURRICULA[TEXTURE].at_step(0)
    return dataclasses.replace(meta, **{**TINY, **overrides})


def assert_grads_match(ref, out, what, cos_min=0.999, rtol=0.02):
    a = np.asarray(ref, np.float64).ravel()
    b = np.asarray(out, np.float64).ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na < 1e-8 and nb < 1e-8:
        return
    cos = float(a @ b / max(na * nb, 1e-30))
    assert cos > cos_min, f"{what}: cos={cos}"
    assert abs(na - nb) / max(na, 1e-12) < rtol, f"{what}: {na} vs {nb}"


def _jax_draws(key, b, rcfg, noise_std):
    """The draws jax render_core makes from `key`, as a port RenderDraws."""
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


def jax_step_draws(key, meta, b, noise_std):
    """Replay of fenerf_tpu.train.loop.train_step's key splits (loop.py:365,
    :376-384, :154, :473) as a port StepDraws."""
    rcfg = meta.render_config()
    k_zi, k_fi, k_zs, k_fs, k_zg, k_fg, _ = jax.random.split(key, 7)

    def z(k):
        kg, ka = jax.random.split(k)
        return (_t(jax.random.normal(kg, (b, meta.latent_geo_dim))),
                _t(jax.random.normal(ka, (b, meta.latent_app_dim))))

    def renders(k, s):
        if s == 1:
            return [_jax_draws(k, b, rcfg, noise_std)]
        return [_jax_draws(kk, b // s, rcfg, noise_std)
                for kk in jax.random.split(k, s)]

    s = 1 if meta.full_batch else meta.batch_split
    return tloop.StepDraws(z(k_zi), renders(k_fi, s), z(k_zs),
                           renders(k_fs, s), z(k_zg), renders(k_fg, s))


def _jax_moments(opt_state, unique):
    """Adam first moments of a JAX optimizer state, by top-level key."""
    inner = opt_state[1]
    if hasattr(inner, "inner_states"):
        out = {}
        for part in inner.inner_states.values():
            mu = part.inner_state[0].mu
            for k, v in mu.items():
                if not isinstance(jax.tree.leaves(
                        v, is_leaf=lambda x: isinstance(
                            x, optax.MaskedNode))[0], optax.MaskedNode):
                    out[k] = v
        return out
    return inner[0].mu


class TestTrainStep:
    @pytest.mark.parametrize("full_batch", [False, True])
    def test_step_matches_jax(self, full_batch):
        jmeta = tiny_texture_meta(jcur, full_batch=full_batch, betas=(0.0,
                                                                      0.9))
        tmeta = tiny_texture_meta(tcur, full_batch=full_batch, betas=(0.0,
                                                                      0.9))
        jstate = jloop.init_train_state(jax.random.key(0), jmeta)
        params = jax_bridge.train_params_from_numpy(
            jax.tree.map(np.asarray, jstate))
        before = {k: [t.clone() for t in tree_leaves(v)]
                  for k, v in params.items()}
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
            jstate, jnp.asarray(imgs), jnp.asarray(labels), key, jscal,
            jmeta)
        tscal = tloop.StepScalars(alpha=torch.tensor(alpha),
                                  noise_std=torch.tensor(noise),
                                  topk_frac=torch.tensor(topk))
        draws = jax_step_draws(key, jmeta, 4, jscal.noise_std)
        tnew, tm = tloop.train_step(tstate, _t(imgs), _t(labels), tscal,
                                    tmeta, draws=draws)
        for k in ("d_img_loss", "d_seg_loss", "g_loss", "g_img_loss",
                  "g_seg_loss", "fake_opacity"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-3, err_msg=k)
        # gradients: Adam's first moment equals the (clipped) gradient at
        # b1 = 0
        for name, jopt, topt in (("g", jnew.opt_g, tnew.opt_g),
                                 ("d_img", jnew.opt_img, tnew.opt_img),
                                 ("d_seg", jnew.opt_seg, tnew.opt_seg)):
            jmu = _jax_moments(jopt, name == "g")
            for key_ in topt.mu:
                for i, (a, b) in enumerate(zip(
                        jax.tree.leaves(jmu[key_]),
                        tree_leaves(topt.mu[key_]))):
                    assert_grads_match(a, b.numpy(), f"{name}/{key_}/{i}")
        # updated parameters within 2 lr of the JAX step's
        for name, lr in (("g_params", tmeta.gen_lr),
                         ("d_img_params", tmeta.disc_img_lr),
                         ("d_seg_params", tmeta.disc_seg_lr)):
            moved = 0.0
            for a, b, b0 in zip(jax.tree.leaves(getattr(jnew, name)),
                                tree_leaves(getattr(tnew, name)),
                                before[name]):
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           atol=2 * lr, rtol=0)
                moved += float((b - b0).abs().sum())
            assert moved > 0, name
        assert tnew.step == int(jnew.step) == 1
        out = jax_bridge.train_params_to_numpy(tnew)
        # the EMA moves (1 - 2/11) of the way to the new parameters
        for a, b in zip(jax.tree.leaves(jnew.ema.params),
                        tree_leaves(tnew.ema.params)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       atol=2 * tmeta.gen_lr, rtol=0)
        assert set(out) == {"g_params", "d_img_params", "d_seg_params"}
        assert "grid_table" not in out["g_params"]

    def test_entry_points_need_cuda_unless_cpu(self):
        meta = tiny_texture_meta(tcur)
        if torch.cuda.is_available():
            pytest.skip("this checks the behaviour without CUDA")
        with pytest.raises(RuntimeError, match="CUDA"):
            tloop.init_train_state(meta)
        st = tloop.init_train_state(meta, device="cpu")
        assert "grid" in st.g_params
