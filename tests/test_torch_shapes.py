"""Port parity for shape extraction: the voxel lattice, eval_volume (the
field's torch route in f32 against the JAX package's XLA route), the .mrc
writer, both meshers, and the extract_shapes CLI of both packages on one
inversion checkpoint. Tiny sizes (TINY_KW, lattices of 8-16)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fenerf_tpu.apps import common as jcommon
from fenerf_tpu.models import generator as jgen
from fenerf_tpu.nn import fields as jfields
from fenerf_tpu.utils import marching as jmarch
from fenerf_tpu.utils import mrc as jmrc
from fenerf_tpu_torch.compat.jax_bridge import from_numpy_tree
from fenerf_tpu_torch.models import generator as tgen
from fenerf_tpu_torch.nn import fields as tfields
from fenerf_tpu_torch.utils import marching as tmarch
from fenerf_tpu_torch.utils import mrc as tmrc

torch.set_num_threads(2)

FLAGSHIP = "TextureEmbeddingPiGAN256SEMANTICDISENTANGLE_DIM_96"
TINY_KW = dict(z_geo_dim=8, z_app_dim=8, hidden_dim=16, map_hidden_dim=16,
               grid_resolution=8, grid_channels=4)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense_jax_params():
    cfg = jfields.get_config(FLAGSHIP, **TINY_KW)
    p = jfields.init_field(jax.random.key(0), cfg)
    p["sigma_head"]["b"] = p["sigma_head"]["b"] + 5.0   # a non-empty volume
    return cfg, p


def _films(jp, jcfg, seed=3):
    rng = np.random.default_rng(seed)
    zg = rng.standard_normal((1, jcfg.z_geo_dim)).astype(np.float32)
    za = rng.standard_normal((1, jcfg.z_app_dim)).astype(np.float32)
    (fg, pg), (fa, pa) = jfields.field_film(jp, jcfg, jnp.asarray(zg),
                                            jnp.asarray(za))
    return {"freq_geo": np.asarray(fg), "phase_geo": np.asarray(pg),
            "freq_app": np.asarray(fa), "phase_app": np.asarray(pa)}


@pytest.mark.parametrize("res,cube", [(8, 0.3), (17, 0.3), (100, 0.3), (256, 0.3)])
def test_voxel_points_equal_jax(res, cube):
    ref = np.asarray(jgen.voxel_points(res, cube))
    out = tgen.voxel_points(res, cube).numpy()
    assert out.shape == (res ** 3, 3)
    np.testing.assert_array_equal(out, ref)


def test_eval_volume_matches_jax_with_padding():
    jcfg, jp = _dense_jax_params()
    tcfg = tfields.get_config(FLAGSHIP, **TINY_KW)
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp))
    f = _films(jp, jcfg)
    jpts = jgen.voxel_points(8, 0.3)
    ref = np.asarray(jgen.eval_volume(
        jp, jcfg, (jnp.asarray(f["freq_geo"]), jnp.asarray(f["phase_geo"])),
        (jnp.asarray(f["freq_app"]), jnp.asarray(f["phase_app"])), jpts,
        chunk=100))                      # 512 points: 6 blocks, 88 padded
    out = tgen.eval_volume(
        tp, tcfg, (_t(f["freq_geo"]), _t(f["phase_geo"])),
        (_t(f["freq_app"]), _t(f["phase_app"])), tgen.voxel_points(8, 0.3),
        chunk=100).numpy()
    assert out.shape == ref.shape == (512, tcfg.output_dim)
    assert np.ptp(ref[:, -1]) > 1e-3     # sigma varies over the lattice
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_mrc_bytes_equal_jax(tmp_path):
    vol = np.random.default_rng(0).standard_normal((5, 6, 7)) \
        .astype(np.float32)
    jmrc.write_mrc(str(tmp_path / "j.mrc"), vol, voxel_size=0.3 / 7)
    tmrc.write_mrc(str(tmp_path / "t.mrc"), vol, voxel_size=0.3 / 7)
    assert (tmp_path / "j.mrc").read_bytes() == \
        (tmp_path / "t.mrc").read_bytes()
    np.testing.assert_array_equal(tmrc.read_mrc(str(tmp_path / "t.mrc")),
                                  vol)


def _sphere(n=20):
    c = np.arange(n, dtype=np.float32) - (n - 1) / 2
    zz, yy, xx = np.meshgrid(c, c, c, indexing="ij")
    return 7.0 - np.sqrt(xx ** 2 + yy ** 2 + zz ** 2)


@pytest.mark.parametrize("mesher", ["marching_cubes", "marching_tetrahedra"])
@pytest.mark.parametrize("volume", ["sphere", "empty"])
def test_meshers_equal_jax(mesher, volume):
    vol = _sphere() if volume == "sphere" else np.zeros((9, 9, 9),
                                                        np.float32)
    kw = dict(level=0.0, spacing=(0.1, 0.1, 0.1), origin=(-1, -1, -1))
    jv, jf = getattr(jmarch, mesher)(vol, **kw)
    tv, tf = getattr(tmarch, mesher)(vol, **kw)
    assert (len(tf) > 100) == (volume == "sphere")
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)


def test_extract_shapes_cli_matches_jax(tmp_path):
    from fenerf_tpu.apps.extract_shapes import main as jmain
    from fenerf_tpu_torch.apps.extract_shapes import main as tmain

    jcfg, jp = _dense_jax_params()
    ckpt = str(tmp_path / "g.npz")
    jcommon.save_generator(ckpt, jp, jp, jp, FLAGSHIP, step=1,
                           field_kwargs=TINY_KW)
    inv = str(tmp_path / "freq_phase_offset_x.npz")
    np.savez(inv, **_films(jp, jcfg, seed=5))
    common = ["--ckpt", ckpt, "--inversion_ckpt", inv,
              "--voxel_resolution", "16", "--export_ply",
              "--iso_level", "4.82"]
    jmain(common + ["--output_dir", str(tmp_path / "j")])
    timings = tmain(common + ["--output_dir", str(tmp_path / "t"),
                              "--device", "cpu"])
    assert timings[0]["name"] == "shape_freq_phase_offset_x"
    ref = jmrc.read_mrc(str(tmp_path / "j" / "shape_freq_phase_offset_x.mrc"))
    out = tmrc.read_mrc(str(tmp_path / "t" / "shape_freq_phase_offset_x.mrc"))
    assert out.shape == (16, 16, 16) and np.isfinite(out).all()
    assert out.min() < 4.82 < out.max()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    ply = (tmp_path / "t" / "shape_freq_phase_offset_x.ply").read_text()
    assert "element face" in ply and not ply.endswith("element face 0\n")


def test_unported_options_raise(tmp_path):
    from fenerf_tpu_torch.apps.extract_shapes import main

    with pytest.raises(NotImplementedError, match="A6"):
        main(["--ckpt", "unused.npz", "--shard_rays"])
