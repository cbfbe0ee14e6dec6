"""Port parity for gradients: the fused field backward's plain torch version
(fenerf_tpu_torch/ops/film_mlp_grad.py) and its autograd Function against
the JAX package's Pallas backward kernel run in interpret mode. Small sizes:
hidden 32, z 8, grid 8^3x4.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
import torch

from fenerf_tpu.core import grid_sample as jgs
from fenerf_tpu.models import generator as jgen
from fenerf_tpu.nn import fields as jfields
from fenerf_tpu.ops import film_mlp as jops
from fenerf_tpu.ops import film_mlp_grad as jgrad
from fenerf_tpu_torch.compat.jax_bridge import from_numpy_tree, tree_leaves
from fenerf_tpu_torch.models import generator as tgen
from fenerf_tpu_torch.nn import fields as tfields
from fenerf_tpu_torch.ops import film_mlp as tops
from fenerf_tpu_torch.ops import film_mlp_grad as tgrad

torch.set_num_threads(2)

FLAGSHIP = "TextureEmbeddingPiGAN256SEMANTICDISENTANGLE_DIM_96"
SMALL = dict(hidden_dim=32, z_geo_dim=8, z_app_dim=8, map_hidden_dim=32)
GRID_SMALL = dict(grid_resolution=8, grid_channels=4)
VARIANTS = [
    (FLAGSHIP, GRID_SMALL),
    ("SIRENBASELINESEMANTICDISENTANGLE", {}),
    ("SPATIALSIRENBASELINESEMANTIC", {}),        # single latent, 19 labels
    ("SIRENBASELINESEMANTICDISENTANGLE_debug", {}),   # label sigmoid
    ("SPATIALSIRENBASELINEHD", {}),              # 64 linear rgb, no labels
]


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw.setdefault("interpret", True)
        kw.pop("cost_estimate", None)
        return orig(*a, **kw)

    for mod in (pl, jops.pl, jgrad.pl):
        monkeypatch.setattr(mod, "pallas_call", interp)


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


class TestPolicy:
    def test_supported_train_and_backend(self):
        for name, jc in jfields.VARIANTS.items():
            assert tops.supported_train(tfields.VARIANTS[name]) == \
                jops.supported_train(jc), name
        cfg = tfields.get_config(FLAGSHIP)
        assert tops.backend_for(cfg, "cuda", train=True) == "kernel_train"
        assert tops.backend_for(cfg, "cpu", train=True) == "torch"
        assert tops.backend_for(tfields.get_config("SPATIALSIRENSEMANTIC"),
                                "cuda", train=True) == "torch"


class TestBackwardReference:
    @pytest.mark.parametrize("name,kw", VARIANTS)
    def test_plain_backward_matches_jax_kernel(self, interpret_pallas, name,
                                               kw):
        """film_mlp_bwd_reference against the Pallas film_mlp_bwd, every
        output group (N not a multiple of the JAX tile)."""
        jcfg, tcfg, jp, tp, pts, dirs, zg, za, rng = _setup(name, **kw)
        jfg, jfa = jfields.field_film(jp, jcfg, jnp.asarray(zg),
                                      jnp.asarray(za))
        gf = None
        if jcfg.grid_channels:
            gf = np.asarray(jgs.grid_sample_3d_fast(
                jp["grid"], jnp.asarray(pts * (2.0 / jcfg.box_side)),
                table_dtype=jnp.bfloat16))
        warped = pts * (2.0 / jcfg.box_side) if jcfg.box_side else pts
        g_out = rng.standard_normal(
            (2, pts.shape[1], jcfg.output_dim)).astype(np.float32)
        ref = jgrad.film_mlp_bwd(
            jp, jcfg, jnp.asarray(warped), jnp.asarray(dirs),
            None if gf is None else jnp.asarray(gf), jfg, jfa,
            jnp.asarray(g_out), tile=64)
        film = lambda f: tuple(_t(x) for x in f)
        pack = tgrad.pack_bwd(tp, tcfg)
        calls = tgrad.film_mlp_bwd_reference.calls
        out = tgrad.film_mlp_bwd(pack, _t(warped), _t(dirs),
                                 None if gf is None else _t(gf), film(jfg),
                                 film(jfa), _t(g_out))
        assert tgrad.film_mlp_bwd_reference.calls == calls + 1
        for li, ((jw, jb), (tw, tb)) in enumerate(zip(ref[0], out[0])):
            assert_grads_match(jw, tw.numpy(), f"dW[{li}]")
            assert_grads_match(jb, tb.numpy(), f"db[{li}]")
        names = ["dpoints", "ddirs", "dgf", "dfg", "dpg", "dfa", "dpa"]
        for nm, r, o in zip(names, ref[1:], out[1:]):
            if r is None:
                assert o is None, nm
                continue
            assert_grads_match(r, o.numpy(), nm)

    def test_agreement_check_catches_a_zeroed_row(self):
        """bwd_agreement, the card's kernel-vs-plain criterion: an output
        equal to the reference passes, a bf16-level perturbation passes,
        and a zeroed row of dpoints or a non-finite dW fails."""
        _, tcfg, _, tp, pts, dirs, zg, za, rng = _setup(
            "SIRENBASELINESEMANTICDISENTANGLE", n=64)
        pack = tgrad.pack_bwd(tp, tcfg)
        fg, fa = tfields.field_film(tp, tcfg, _t(zg), _t(za))
        g_out = _t(rng.standard_normal((2, 64, tcfg.output_dim)))
        ref = tgrad.film_mlp_bwd(pack, _t(pts), _t(dirs), None, fg, fa, g_out)

        def perturbed(fn):
            out = ([(w.clone(), b.clone()) for w, b in ref[0]],
                   *(None if t is None else t.clone() for t in ref[1:]))
            fn(out)
            return {nm: ok for nm, _, _, ok in tgrad.bwd_agreement(out, ref)}

        same = perturbed(lambda o: None)
        assert len(same) == 2 * len(ref[0]) + 6 and all(same.values())
        assert all(perturbed(lambda o: o[0][3][0].mul_(1 + 2 ** -9)).values())
        zeroed = perturbed(lambda o: o[1][1, 7].zero_())
        assert not zeroed["dpoints"]
        assert sum(not ok for ok in zeroed.values()) == 1
        assert not perturbed(lambda o: o[0][0][0][0, 0].fill_(
            float("nan")))["dW[0]"]

    def test_cuda_tensor_without_card_raises(self):
        _, tcfg, _, tp, pts, dirs, zg, za, _ = _setup(
            "SIRENBASELINESEMANTICDISENTANGLE", n=16)
        pack = tgrad.pack_bwd(tp, tcfg)
        fg, fa = tfields.field_film(tp, tcfg, _t(zg), _t(za))
        meta = _t(pts).to("meta")
        with pytest.raises(ValueError, match="no kernel"):
            tgrad.film_mlp_bwd(pack, meta, meta, None, fg, fa,
                               torch.zeros(2, 16, 22, device="meta"))


class TestTrainableField:
    @pytest.mark.parametrize("name,kw", VARIANTS[:3])
    def test_matches_jax_pallas_train(self, interpret_pallas, name, kw):
        """FilmMlpTrainable (plain backward on the CPU) against JAX
        apply_field(backend='pallas_train'): gradients of every parameter
        leaf, mapping nets and texture grid included."""
        jcfg, tcfg, jp, tp, pts, dirs, zg, za, _ = _setup(name, **kw)

        def jloss(p):
            fg, fa = jfields.field_film(p, jcfg, jnp.asarray(zg),
                                        jnp.asarray(za))
            out = jfields.apply_field(p, jcfg, jnp.asarray(pts),
                                      jnp.asarray(dirs), fg, fa,
                                      backend="pallas_train")
            return jnp.sum(out ** 2)

        jg = jax.grad(jloss)(jp)
        leaves = tree_leaves(tp)
        for t in leaves:
            t.requires_grad_(True)
        fg, fa = tfields.field_film(tp, tcfg, _t(zg), _t(za))
        out = tfields.apply_field(tp, tcfg, _t(pts), _t(dirs), fg, fa,
                                  backend="kernel_train")
        tg = torch.autograd.grad((out ** 2).sum(), leaves)
        paths = jax.tree_util.tree_flatten_with_path(jg)[0]
        assert len(paths) == len(tg)
        for (path, a), t in zip(paths, tg):
            assert_grads_match(a, t.numpy(), jax.tree_util.keystr(path))

    def test_pack_follows_parameter_updates(self):
        """The operands are packed from the current parameters on every
        call: changing a weight in place changes the next gradient."""
        _, tcfg, _, tp, pts, dirs, zg, za, _ = _setup(
            "SIRENBASELINESEMANTICDISENTANGLE", n=32)
        w = tp["trunk"][3]["w"].requires_grad_(True)

        def grad():
            fg, fa = tfields.field_film(tp, tcfg, _t(zg), _t(za))
            out = tfields.apply_field(tp, tcfg, _t(pts), _t(dirs), fg, fa,
                                      backend="kernel_train")
            return torch.autograd.grad(out.sum(), w)[0]

        g0 = grad()
        with torch.no_grad():
            tp["color"][0]["w"].mul_(-1.0)
        assert not torch.allclose(g0, grad())
