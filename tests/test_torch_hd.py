"""Port parity for the HD path: the neural renderer
(fenerf_tpu_torch/nn/neural_renderer.py) against
fenerf_tpu.nn.neural_renderer on the same parameters at an 8^2 feature map
(nearest and bilinear+blur upsampling, instance norm, no RGB skip, an
input adapter); render_hd against the JAX package's on a tiny
SPATIALSIRENSEMANTICHD field with both heads; the neural renderers in the
generator .npz both ways; and render_multiview --hd against the JAX CLI,
decoded PNG for PNG. Tolerance 1e-5 (f32 convolutions in another order).
"""
import math

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp
import torch

from fenerf_tpu.apps import common as jcommon
from fenerf_tpu.models import generator as jgen
from fenerf_tpu.nn import fields as jfields
from fenerf_tpu.nn import neural_renderer as jnr
from fenerf_tpu_torch.apps import common as tcommon
from fenerf_tpu_torch.compat.jax_bridge import (from_numpy_tree, tree_leaves,
                                               to_numpy_tree)
from fenerf_tpu_torch.models import generator as tgen
from fenerf_tpu_torch.nn import fields as tfields
from fenerf_tpu_torch.nn import neural_renderer as tnr

torch.set_num_threads(2)

HD = "SPATIALSIRENSEMANTICHD"
HD_KW = dict(z_geo_dim=8, z_app_dim=8, hidden_dim=16, map_hidden_dim=16)
TOL = 1e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _nr_pair(seed, **kw):
    """A JAX NeuralRendererConfig, its random parameters, and both as the
    port holds them."""
    jcfg = jnr.NeuralRendererConfig(**kw)
    jp = jnr.init_neural_renderer(jax.random.key(seed), jcfg)
    return jcfg, jp, tnr.NeuralRendererConfig(**kw), from_numpy_tree(
        _np_tree(jp))


NR_CASES = {
    "nn_feat": dict(n_feat=16, input_dim=16, min_feat=8, img_size=32,
                    input_size=8, upsample_feat="nn",
                    upsample_rgb="bilinear"),
    "bilinear_feat": dict(n_feat=16, input_dim=16, min_feat=8, img_size=32,
                          input_size=8, upsample_feat="bilinear",
                          upsample_rgb="nn"),
    "norm_no_skip_conv_in": dict(n_feat=16, input_dim=12, min_feat=4,
                                 img_size=16, input_size=8, use_norm=True,
                                 use_rgb_skip=False, final_actvn=False),
    "seg_head": dict(n_feat=16, input_dim=64, min_feat=8, img_size=32,
                     input_size=8, out_dim=19, final_actvn=False),
}


@pytest.mark.parametrize("case", sorted(NR_CASES))
def test_neural_renderer_matches_jax(case):
    jcfg, jp, tcfg, tp = _nr_pair(3, **NR_CASES[case])
    assert tcfg.n_blocks == jcfg.n_blocks
    assert len(tree_leaves(tp)) == len(jax.tree_util.tree_leaves(jp))
    x = np.random.default_rng(1).standard_normal(
        (2, jcfg.input_dim, 8, 8)).astype(np.float32)
    ref = np.asarray(jnr.apply_neural_renderer(jp, jcfg, jnp.asarray(x)))
    out = tnr.apply_neural_renderer(tp, tcfg, torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, jcfg.out_dim if jcfg.use_rgb_skip
                                      else 3, jcfg.img_size // 8 * 8,
                                      jcfg.img_size // 8 * 8)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def test_init_tree_matches_jax_layout():
    kw = NR_CASES["norm_no_skip_conv_in"]
    jp = jnr.init_neural_renderer(jax.random.key(0),
                                  jnr.NeuralRendererConfig(**kw))
    tp = tnr.init_neural_renderer(torch.Generator().manual_seed(0),
                                  tnr.NeuralRendererConfig(**kw))
    assert [tuple(x.shape) for x in jax.tree_util.tree_leaves(jp)] == [
        tuple(x.shape) for x in tree_leaves(tp)]


@pytest.fixture(scope="module")
def hd_setup():
    """A tiny HD field (sigma bias +5: an opaque volume) and both heads,
    as JAX trees."""
    cfg = jfields.get_config(HD, **HD_KW)
    p = jfields.init_field(jax.random.key(0), cfg)
    p["sigma_head"]["b"] = p["sigma_head"]["b"] + 5.0
    img = _nr_pair(1, n_feat=16, input_dim=64, min_feat=8, img_size=32,
                   input_size=8)
    seg = _nr_pair(2, **NR_CASES["seg_head"])
    return cfg, p, img, seg


def test_render_hd_matches_jax(hd_setup):
    jcfg, jp, (jicfg, jip, ticfg, tip), (jscfg, jsp, tscfg, tsp) = hd_setup
    tcfg = tfields.get_config(HD, **HD_KW)
    tp = from_numpy_tree(_np_tree(jp))
    z = np.random.default_rng(2).standard_normal((1, 8)).astype(np.float32)
    kw = dict(img_size=8, num_steps=4, perturb=False, hierarchical=False,
              fill_mode=None)
    camera = (math.pi / 2, math.pi / 2 + 0.2, 12.0)
    fg, fa = jfields.field_film(jp, jcfg, jnp.asarray(z), jnp.asarray(z))
    ref = jgen.render_hd(jp, jcfg, jgen.RenderConfig(**kw),
                         jax.random.key(0), fg, fa, 1, jip, jicfg, jsp, jscfg,
                         camera=camera)["pixels"]
    tz = torch.from_numpy(z)
    tfg, tfa = tfields.field_film(tp, tcfg, tz, tz)
    out = tgen.render_hd(tp, tcfg, tgen.RenderConfig(**kw), tfg, tfa, 1,
                         tip, ticfg, tsp, tscfg, camera=camera)
    assert out["pixels"].shape == (1, 19 + 3, 32, 32)
    assert out["depth"].shape == (1, 8, 8)
    np.testing.assert_allclose(out["pixels"].numpy(), np.asarray(ref),
                               atol=TOL, rtol=TOL)
    assert np.ptp(np.asarray(ref)[:, -3:]) > 0.1


def test_neural_renderers_npz_both_ways(hd_setup, tmp_path):
    jcfg, jp, (jicfg, jip, ticfg, tip), (jscfg, jsp, tscfg, tsp) = hd_setup
    jpath = str(tmp_path / "jax.npz")
    jcommon.save_generator(jpath, jp, jp, jp, HD, step=1,
                           field_kwargs=HD_KW,
                           neural_renderers={"nr_img": (jip, jicfg),
                                             "nr_seg": (jsp, jscfg)})
    got = tcommon.load_neural_renderers(jpath, device="cpu")
    assert sorted(got) == ["nr_img", "nr_seg"]
    for key, (p, cfg) in (("nr_img", (jip, ticfg)), ("nr_seg", (jsp, tscfg))):
        assert got[key][1] == cfg
        for a, b in zip(jax.tree_util.tree_leaves(p),
                        tree_leaves(got[key][0])):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the port writes, the JAX package reads
    tp = from_numpy_tree(_np_tree(jp))
    tpath = str(tmp_path / "port.npz")
    tcommon.save_generator(tpath, tp, tp, tp, HD, step=2,
                           field_kwargs=HD_KW,
                           neural_renderers={"nr_img": (tip, ticfg),
                                             "nr_seg": (tsp, tscfg)})
    back = jcommon.load_neural_renderers(tpath)
    assert back["nr_seg"][1] == jscfg and back["nr_img"][1] == jicfg
    for key, p in (("nr_img", tip), ("nr_seg", tsp)):
        for a, b in zip(jax.tree_util.tree_leaves(back[key][0]),
                        tree_leaves(to_numpy_tree(p))):
            np.testing.assert_array_equal(np.asarray(a), b)
    assert tcommon.load_neural_renderers(
        str(tmp_path / "port.npz"), device="cpu")["nr_img"][1] == ticfg
    # a checkpoint without heads has none
    plain = str(tmp_path / "plain.npz")
    tcommon.save_generator(plain, tp, tp, tp, HD, step=2,
                           field_kwargs=HD_KW)
    assert tcommon.load_neural_renderers(plain, device="cpu") == {}


def _png(path):
    return np.asarray(Image.open(path).convert("RGB")).astype(np.int16)


def test_hd_cli_matches_jax(hd_setup, tmp_path, monkeypatch):
    """render_multiview --hd --deterministic on a JAX-written HD checkpoint,
    both packages, on one --z_file (the truncation average the JAX
    package's, as tests/test_torch_multiview.py does)."""
    from fenerf_tpu.apps.render_multiview import main as jmain
    from fenerf_tpu_torch.apps.render_multiview import main as tmain

    jcfg, jp, (jicfg, jip, *_), (jscfg, jsp, *_) = hd_setup
    ckpt = str(tmp_path / "hd.npz")
    jcommon.save_generator(ckpt, jp, jp, jp, HD, step=1, field_kwargs=HD_KW,
                           neural_renderers={"nr_img": (jip, jicfg),
                                             "nr_seg": (jsp, jscfg)})
    z = str(tmp_path / "z.npz")
    rng = np.random.default_rng(5)
    np.savez(z, z_geo=rng.standard_normal((1, 8)).astype(np.float32),
             z_app=rng.standard_normal((1, 8)).astype(np.float32))
    javg = jfields.avg_film(jp, jcfg, jax.random.key(42))
    tavg = tuple(tuple(torch.from_numpy(np.array(x)) for x in br)
                 for br in javg)
    monkeypatch.setattr(tfields, "avg_film", lambda *a, **k: tavg)
    common = ["--ckpt", ckpt, "--z_file", z, "--seeds", "0", "--image_size",
              "32", "--num_steps", "4", "--deterministic", "--hd"]
    jmain(common + ["--output_dir", str(tmp_path / "j")])
    (seed, views, ms), = tmain(common + ["--output_dir", str(tmp_path / "t"),
                                         "--device", "cpu"])
    assert views.shape == (5, 19 + 3, 32, 32) and np.isfinite(views).all()
    for kind in ("img", "seg"):
        ref = _png(tmp_path / "j" / f"{kind}_0.png")
        out = _png(tmp_path / "t" / f"{kind}_0.png")
        assert out.shape == ref.shape == (2 + 34, 2 + 5 * 34, 3)
        assert np.abs(out - ref).max() <= 1, kind
    assert np.ptp(_png(tmp_path / "j" / "img_0.png")) > 20
    # a checkpoint without heads is refused
    plain = str(tmp_path / "plain.npz")
    jcommon.save_generator(plain, jp, jp, jp, HD, step=1, field_kwargs=HD_KW)
    with pytest.raises(ValueError, match="no neural-renderer heads"):
        tmain(["--ckpt", plain, "--hd", "--device", "cpu", "--output_dir",
               str(tmp_path / "x")])
