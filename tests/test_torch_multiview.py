"""Port parity for the multiview CLI: the JAX package's
render_multiview and the port's on one checkpoint and one --z_file, in
--deterministic mode (no jitter, no hierarchy, f32), compared as decoded
PNGs; the default route (hierarchical, bf16) on the CPU; and the options
that wait for later slices. Tiny sizes (TINY_KW, 16^2, 4 x 2 steps)."""
import numpy as np
import pytest
from PIL import Image

import jax
import torch

from fenerf_tpu.apps import common as jcommon
from fenerf_tpu.nn import fields as jfields
from fenerf_tpu_torch.nn import fields as tfields

torch.set_num_threads(2)

FLAGSHIP = "TextureEmbeddingPiGAN256SEMANTICDISENTANGLE_DIM_96"
TINY_KW = dict(z_geo_dim=8, z_app_dim=8, hidden_dim=16, map_hidden_dim=16,
               grid_resolution=8, grid_channels=4)
ARGS = ["--seeds", "0", "1", "--image_size", "16", "--num_steps", "4"]


@pytest.fixture(scope="module")
def dense_ckpt(tmp_path_factory):
    """A tiny flagship checkpoint written by the JAX package, sigma bias +5
    (an opaque volume: random init renders ~zero opacity)."""
    d = tmp_path_factory.mktemp("mv")
    cfg = jfields.get_config(FLAGSHIP, **TINY_KW)
    p = jfields.init_field(jax.random.key(0), cfg)
    p["sigma_head"]["b"] = p["sigma_head"]["b"] + 5.0
    path = str(d / "generator.npz")
    jcommon.save_generator(path, p, p, p, FLAGSHIP, step=1,
                           field_kwargs=TINY_KW)
    rng = np.random.default_rng(4)
    z = str(d / "z.npz")
    np.savez(z, z_geo=rng.standard_normal((2, 8)).astype(np.float32),
             z_app=rng.standard_normal((2, 8)).astype(np.float32))
    return path, z, cfg, p


def _png(path):
    return np.asarray(Image.open(path).convert("RGB")).astype(np.int16)


def test_deterministic_cli_matches_jax(dense_ckpt, tmp_path, monkeypatch):
    from fenerf_tpu.apps.render_multiview import main as jmain
    from fenerf_tpu_torch.apps.render_multiview import main as tmain

    ckpt, z, jcfg, jp = dense_ckpt
    # the truncation average: 10k latents from each package's own RNG
    # stream, which never agree (ROADMAP F3), so the port takes the JAX
    # package's average here
    javg = jfields.avg_film(jp, jcfg, jax.random.key(42))
    tavg = tuple(tuple(torch.from_numpy(np.array(x)) for x in br)
                 for br in javg)
    monkeypatch.setattr(tfields, "avg_film", lambda *a, **k: tavg)
    common = ARGS + ["--ckpt", ckpt, "--z_file", z, "--deterministic"]
    jmain(common + ["--output_dir", str(tmp_path / "j")])
    sheets = tmain(common + ["--output_dir", str(tmp_path / "t"),
                             "--device", "cpu"])
    assert [s[0] for s in sheets] == [0, 1]
    for seed in (0, 1):
        for kind in ("img", "seg"):
            ref = _png(tmp_path / "j" / f"{kind}_{seed}.png")
            out = _png(tmp_path / "t" / f"{kind}_{seed}.png")
            assert out.shape == ref.shape == (2 + 18, 2 + 5 * 18, 3)
            assert np.abs(out - ref).max() <= 1, (kind, seed)
        assert np.ptp(ref) > 50          # the views are not blank


def test_default_route_runs(dense_ckpt, tmp_path):
    from fenerf_tpu_torch.apps.render_multiview import main

    ckpt, *_ = dense_ckpt
    sheets = main(["--ckpt", ckpt, "--seeds", "3", "--image_size", "16",
                   "--num_steps", "4", "--output_dir", str(tmp_path),
                   "--device", "cpu"])
    (seed, views, ms), = sheets
    assert ms > 0
    assert seed == 3 and views.shape == (5, 19 + 3, 16, 16)
    assert np.isfinite(views).all()
    for kind in ("img", "seg"):
        assert _png(tmp_path / f"{kind}_3.png").shape == (20, 92, 3)


@pytest.mark.parametrize("flag", ["--hd", "--shard_rays"])
def test_unported_options_raise(flag):
    from fenerf_tpu_torch.apps.render_multiview import main

    with pytest.raises(NotImplementedError, match="A6"):
        main(["--ckpt", "unused.npz", flag])


def test_cuda_is_the_default_device(dense_ckpt, monkeypatch, tmp_path):
    from fenerf_tpu_torch.apps.render_multiview import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--ckpt", dense_ckpt[0], "--output_dir", str(tmp_path)])
