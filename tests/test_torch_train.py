"""Port parity for the training pieces: EMA, the curricula field by field,
the optimizer against optax (the clip below, at and above max_norm), and
the topk term against the JAX package's values. The whole step is
tests/test_torch_train_step.py.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from fenerf_tpu.train import curriculum as jcur
from fenerf_tpu.train import ema as jema
from fenerf_tpu.train import loop as jloop
from fenerf_tpu_torch.compat import jax_bridge
from fenerf_tpu_torch.compat.jax_bridge import tree_leaves
from fenerf_tpu_torch.train import curriculum as tcur
from fenerf_tpu_torch.train import ema as tema
from fenerf_tpu_torch.train import loop as tloop

torch.set_num_threads(2)

TEXTURE = "CelebA_double_semantic_texture_embedding_256_dim_96"


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


class TestEmaAndCurriculum:
    def test_ema_matches_jax(self):
        rng = np.random.default_rng(0)
        p0 = {"w": rng.standard_normal(5).astype(np.float32)}
        js = jema.ema_init({"w": jnp.asarray(p0["w"])}, 0.999)
        ts = tema.ema_init({"w": _t(p0["w"])}, 0.999)
        for _ in range(12):
            p = rng.standard_normal(5).astype(np.float32)
            js = jema.ema_update(js, {"w": jnp.asarray(p)})
            ts = tema.ema_update(ts, {"w": _t(p)})
            np.testing.assert_array_equal(ts.params["w"].numpy(),
                                          np.asarray(js.params["w"]))
        assert ts.num_updates == int(js.num_updates) == 12

    def test_ema_copies_params(self):
        p = {"w": torch.zeros(3)}
        st = tema.ema_init(p, 0.5)
        tema.ema_update(st, {"w": torch.ones(3)})
        assert float(p["w"].sum()) == 0.0

    def test_registries_agree_field_by_field(self):
        assert set(tcur.CURRICULA) == set(jcur.CURRICULA)
        for name, jc in jcur.CURRICULA.items():
            tc = tcur.CURRICULA[name]
            assert (tc.name, tc.end_step, tc.defaults) == \
                (jc.name, jc.end_step, jc.defaults), name
            assert tc.stages == jc.stages, name
            for start, _ in jc.stages:
                for step in (start, start + 1):
                    assert dataclasses.asdict(tc.at_step(step)) == \
                        dataclasses.asdict(jc.at_step(step)), (name, step)
                    assert tc.alpha(step) == jc.alpha(step)
                    assert tc.stage_start(step) == jc.stage_start(step)
                    assert tc.next_stage_start(step) == \
                        jc.next_stage_start(step)

    @pytest.mark.parametrize("name", ["CelebA_double_semantic", TEXTURE,
                                      "CelebA", "smoke"])
    def test_derived_configs(self, name):
        jm = jcur.CURRICULA[name].at_step(0)
        tm = tcur.CURRICULA[name].at_step(0)
        assert dataclasses.asdict(tm.field_config()) == \
            dataclasses.asdict(jm.field_config())
        assert {k: v for k, v in dataclasses.asdict(
            tm.render_config()).items() if k != "backend"} == {
            k: v for k, v in dataclasses.asdict(jm.render_config()).items()
            if k not in ("grad_rays", "backend")}
        assert tm.render_config().backend == "torch"  # the port's default
        assert dataclasses.asdict(tm.disc_seg_config()) == \
            dataclasses.asdict(jm.disc_seg_config())
        for step in (0, 700, 20_000):
            assert tm.nerf_noise(step) == jm.nerf_noise(step)
            assert tm.topk_fraction(step) == jm.topk_fraction(step)

    def test_grid_family_raises(self):
        with pytest.raises(NotImplementedError):
            tcur.CURRICULA["CelebA_latent_grid"].at_step(0).field_config()


class TestOptimizer:
    @pytest.mark.parametrize("scale,wd,unique", [
        (1.0, 0.0, True),     # norm below max_norm
        (None, 0.0, True),    # norm exactly max_norm: clipped (>=)
        (50.0, 1e-3, False),  # far above, with weight decay
    ])
    def test_matches_optax(self, scale, wd, unique):
        over = dict(weight_decay=wd, unique_lr=unique, betas=(0.5, 0.9))
        meta = dataclasses.replace(tcur.CURRICULA[TEXTURE].at_step(0),
                                   **over)
        jmeta = dataclasses.replace(jcur.CURRICULA[TEXTURE].at_step(0),
                                    **over)
        rng = np.random.default_rng(1)
        shapes = {"trunk": [(4, 3), (3,)], "geo_map": [(5, 2)],
                  "color_head": [(2, 2)]}
        params = {k: [rng.standard_normal(s).astype(np.float32)
                      for s in v] for k, v in shapes.items()}
        jp = jax.tree.map(jnp.asarray, params)
        tp = jax_bridge.from_numpy_tree(params)
        tx = jloop.make_g_optimizer(jmeta, jp)
        jst = tx.init(jp)
        opt = tloop.make_g_optimizer(meta)
        tst = opt.init(tp)
        for _ in range(3):
            g = {k: [rng.standard_normal(s).astype(np.float32) for s in v]
                 for k, v in shapes.items()}
            norm = np.sqrt(sum((x.astype(np.float64) ** 2).sum()
                               for x in jax.tree.leaves(g)))
            f = (meta.grad_clip / norm) if scale is None else scale
            g = jax.tree.map(lambda x: (x * f).astype(np.float32), g)
            upd, jst = tx.update(jax.tree.map(jnp.asarray, g), jst, jp)
            jp = optax.apply_updates(jp, upd)
            tst = opt.step(tp, jax_bridge.from_numpy_tree(g), tst)
            for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=1e-5, atol=1e-7)
        assert tst.count == 3


class TestTopk:
    @pytest.mark.parametrize("frac,n_chunks", [
        (1.0, 1), (0.6, 1), (0.6, 2), (0.75, 2), (0.99 ** 3.5, 4),
        (0.51, 2)])
    def test_matches_jax(self, frac, n_chunks):
        scores = np.random.default_rng(2).standard_normal(8).astype(
            np.float32)
        ref = jloop._chunk_topk_softplus(jnp.asarray(scores),
                                         jnp.asarray(frac, jnp.float32),
                                         n_chunks)
        out = tloop._chunk_topk_softplus(_t(scores),
                                         torch.tensor(frac), n_chunks)
        np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)
