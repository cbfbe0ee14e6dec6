"""A run that the JAX package wrote, opened by the port: the generator.npz
and train_state.npz the JAX trainer writes (fenerf_tpu/apps/train.py:380-394
through apps/common.py::save_generator and utils/checkpoint.py::save), of
the flagship curriculum at tiny widths, loaded by the port's readers and
rendered within 1 uint8 of the JAX package's render of the same trees
(RGB and labels); and invert's targets from a JPEG photo, equal to the
JAX package's PIL path.
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
from fenerf_tpu.train import curriculum as jcur
from fenerf_tpu.train import loop as jloop
from fenerf_tpu.utils import checkpoint as jckpt
from fenerf_tpu_torch.apps.common import load_generator
from fenerf_tpu_torch.data import synthetic
from fenerf_tpu_torch.models import generator as tgen
from fenerf_tpu_torch.train import curriculum as tcur
from fenerf_tpu_torch.train import loop as tloop
from fenerf_tpu_torch.utils import checkpoint as tckpt
from fenerf_tpu_torch.utils.image import to_uint8

# tmp_path: the fixture that empties each test's directory when it ends
from test_torch_train_cli import tmp_path  # noqa: F401
from test_torch_train_step import tiny_texture_meta

torch.set_num_threads(2)

RENDER = dict(img_size=12, num_steps=6, perturb=False, hierarchical=False,
              sample_dist=None, fill_mode="seg_padding_background")


def _jax_run_state(meta):
    """The JAX trainer's state as a run leaves it: G's trees apart from
    its EMAs (a small shift), the volume opaque (sigma bias +5), step 5."""
    st = jloop.init_train_state(jax.random.key(0), meta)
    g = dict(st.g_params)
    g["sigma_head"] = {**g["sigma_head"],
                       "b": g["sigma_head"]["b"] + 5.0}
    leaves, treedef = jax.tree_util.tree_flatten(g)
    rng = np.random.default_rng(1)
    shifted = [x + 0.01 * rng.standard_normal(x.shape).astype(np.float32)
               for x in leaves]
    ema = jax.tree_util.tree_unflatten(treedef, shifted)
    return st._replace(g_params=g, ema=st.ema._replace(params=ema),
                       step=jnp.asarray(5, st.step.dtype))


def _u8(pix):
    pix = np.asarray(pix, np.float32)
    return (to_uint8(pix[:, -3:], normalize=False).astype(np.int16),
            to_uint8(pix[:, :-3], normalize=False).astype(np.int16))


def test_jax_run_renders_in_the_port(tmp_path):
    jmeta = tiny_texture_meta(jcur)
    tmeta = tiny_texture_meta(tcur)
    st = _jax_run_state(jmeta)
    gen_path = str(tmp_path / "generator.npz")
    state_path = str(tmp_path / "train_state.npz")
    jckpt.save(state_path, st)
    fkw = {"z_geo_dim": jmeta.latent_geo_dim,
           "z_app_dim": jmeta.latent_app_dim,
           "n_labels": jmeta.output_dim - 4, **dict(jmeta.field_overrides)}
    jcommon.save_generator(gen_path, st.g_params, st.ema.params,
                           st.ema2.params, jmeta.model, int(st.step),
                           field_kwargs=fkw)

    params, ema, _, cfg, config = load_generator(gen_path, device="cpu")
    assert config["step"] == 5 and cfg == tmeta.field_config()
    tst = tckpt.load(state_path, tloop.init_train_state(tmeta, device="cpu"))
    assert tst.step == 5

    rng = np.random.default_rng(2)
    z = rng.standard_normal((2, 8)).astype(np.float32)
    camera = (math.pi / 2, math.pi / 2 + 0.15, 12.0)
    jcfg = jmeta.field_config()
    renders = {}
    for name, jtree, ttree in (("generator ema", st.ema.params, ema),
                               ("generator params", st.g_params, params),
                               ("train_state g", st.g_params,
                                tst.g_params),
                               ("train_state ema", st.ema.params,
                                tst.ema.params)):
        ref = jgen.render_any(jtree, jcfg, jgen.RenderConfig(**RENDER),
                              jax.random.key(0), jnp.asarray(z),
                              jnp.asarray(z), camera=camera)["pixels"]
        out = tgen.render_any(ttree, cfg, tgen.RenderConfig(**RENDER),
                              torch.from_numpy(z), torch.from_numpy(z),
                              camera=camera)["pixels"].numpy()
        assert out.shape == (2, 22, 12, 12) and np.isfinite(out).all()
        for kind, a, b in zip(("rgb", "labels"), _u8(out), _u8(ref)):
            assert np.abs(a - b).max() <= 1, (name, kind)
        renders[name] = _u8(ref)[0]
    # the trees differ, and the views are not blank
    assert np.abs(renders["generator ema"]
                  - renders["generator params"]).max() > 1
    assert np.ptp(renders["generator ema"]) > 20


def test_invert_targets_from_a_jpeg(tmp_path):
    """load_targets on a committed 1024^2 JPEG and a label PNG of another
    size (nearest-resized to the photo), with and without the background
    mask: equal to the JAX package's."""
    from fenerf_tpu.apps.invert import load_targets as jload
    from fenerf_tpu_torch.apps.invert import load_targets as tload

    photo = str(synthetic.FIXTURES / sorted(synthetic.fixture_digests())[0])
    seg = str(tmp_path / "seg.png")
    Image.fromarray(synthetic.label_map(np.random.default_rng(3), 96),
                    mode="L").save(seg)
    for args in ((64, False), (64, True, True), (32, False, False, False)):
        want = jload(photo, seg, *args)
        got = tload(photo, seg, *args)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))
