"""Port parity for the multiview CLI: the JAX package's
render_multiview and the port's on one checkpoint and one --z_file, in
--deterministic mode (no jitter, no hierarchy, f32), compared as decoded
PNGs; the default route (hierarchical, bf16) on the CPU; and the option
that waits for a later slice. Tiny sizes (TINY_KW, 16^2, 4 x 2 steps)."""
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
def test_unported_options_raise(flag, dense_ckpt, tmp_path, monkeypatch):
    """Both options are ported. --hd (tests/test_torch_hd.py) refuses a
    checkpoint without the neural renderers' heads, as the JAX CLI does.
    --shard_rays in four strips (the CPU four times over, through
    apps/common.py::visible_devices) gives the plain run's views bit for bit
    (whole ray_chunk blocks per strip); a row count the strips do not
    divide, and --hd with it, raise."""
    from fenerf_tpu_torch.apps import common as tcommon
    from fenerf_tpu_torch.apps.render_multiview import main

    ckpt, *_ = dense_ckpt
    if flag == "--hd":
        with pytest.raises(ValueError, match="no neural-renderer heads"):
            main(["--ckpt", ckpt, flag, "--device", "cpu", "--output_dir",
                  str(tmp_path)])
        return
    monkeypatch.setattr(tcommon, "visible_devices", lambda dev: [dev] * 4)
    args = ARGS + ["--ckpt", ckpt, "--device", "cpu", "--ray_chunk", "64"]
    plain = main(args + ["--output_dir", str(tmp_path / "a")])
    strips = main(args + ["--output_dir", str(tmp_path / "b"), flag])
    assert len(plain) == len(strips) == 2
    for (s0, v0, _), (s1, v1, _) in zip(plain, strips):
        assert s0 == s1 and np.array_equal(v0, v1)
    odd = ["14" if a == "16" else a for a in args]
    with pytest.raises(ValueError, match="not divisible by 4 devices"):
        main(odd + ["--output_dir", str(tmp_path / "c"), flag])
    with pytest.raises(ValueError, match="single-device"):
        main(args + ["--output_dir", str(tmp_path / "c"), flag, "--hd"])


def test_cuda_is_the_default_device(dense_ckpt, monkeypatch, tmp_path):
    from fenerf_tpu_torch.apps.render_multiview import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--ckpt", dense_ckpt[0], "--output_dir", str(tmp_path)])


def test_grid_family_deterministic_cli_matches_jax(tmp_path):
    """A latent-grid checkpoint: RGB sheets only (white background, no
    seg), from z without W truncation; --deterministic --z_file PNGs of
    both CLIs within 1 uint8."""
    from fenerf_tpu.apps.render_multiview import main as jmain
    from fenerf_tpu.nn import latent_grid_field as jlgf
    from fenerf_tpu_torch.apps.render_multiview import main as tmain

    grid_kw = dict(z_dim=8, hidden_dim=16, grid_res=8, grid_ch=8, ch_max=16,
                   map_hidden_dim=16)
    gp = jlgf.init_grid_field(jax.random.key(1), jlgf.get_grid_config(
        "SPATIALSIRENGRID", **grid_kw))
    gp["sigma_head"]["b"] = gp["sigma_head"]["b"] + 5.0
    ckpt = str(tmp_path / "grid.npz")
    jcommon.save_generator(ckpt, gp, gp, gp, "SPATIALSIRENGRID", step=1,
                           field_kwargs=grid_kw)
    z = str(tmp_path / "z.npz")
    np.savez(z, z_geo=np.random.default_rng(6).standard_normal(
        (2, 8)).astype(np.float32))
    common = ARGS + ["--ckpt", ckpt, "--z_file", z, "--deterministic"]
    jmain(common + ["--output_dir", str(tmp_path / "j")])
    sheets = tmain(common + ["--output_dir", str(tmp_path / "t"),
                             "--device", "cpu"])
    assert [s[1].shape for s in sheets] == [(5, 3, 16, 16)] * 2
    for seed in (0, 1):
        ref = _png(tmp_path / "j" / f"img_{seed}.png")
        out = _png(tmp_path / "t" / f"img_{seed}.png")
        assert out.shape == ref.shape == (2 + 18, 2 + 5 * 18, 3)
        assert np.abs(out - ref).max() <= 1, seed
        assert np.ptp(ref) > 50
        assert not (tmp_path / "t" / f"seg_{seed}.png").exists()
