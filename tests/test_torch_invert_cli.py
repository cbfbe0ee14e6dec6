"""The port's inversion CLI on the CPU, mirroring tests/test_apps.py's
TestInvert: a tiny run with its warm start (the prior W + offsets become
the new base), the refusal of --lambda_percept without LPIPS weights, the
PNG-only targets, the refusal of a grid-family checkpoint, and the
reconstruction video against the JAX package's triptych. Tiny sizes
(TINY_KW, 16^2, 4 steps; the 256px eval render at 4 samples per ray,
not the reference's 48, which take ~25 s per eval on two CPU threads)."""
import os

import numpy as np
import pytest
from PIL import Image

import jax
import torch

from fenerf_tpu.apps import common as jcommon
from fenerf_tpu.nn import fields as jfields
from fenerf_tpu_torch.apps import invert
from fenerf_tpu_torch.apps.invert import main

torch.set_num_threads(2)

FLAGSHIP = "TextureEmbeddingPiGAN256SEMANTICDISENTANGLE_DIM_96"
TINY_KW = dict(z_geo_dim=8, z_app_dim=8, hidden_dim=16, map_hidden_dim=16,
               grid_resolution=8, grid_channels=4)
KEYS = {f"{pre}{name}_{br}" for pre in ("", "w_", "offset_")
        for name in ("freq", "phase") for br in ("geo", "app")}


@pytest.fixture(autouse=True)
def cheap_eval(monkeypatch):
    monkeypatch.setattr(invert, "EVAL_NUM_STEPS", 4)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A tiny flagship checkpoint (sigma bias +5: gradients reach W) and
    a random PNG photo / label-map pair."""
    d = tmp_path_factory.mktemp("inv")
    cfg = jfields.get_config(FLAGSHIP, **TINY_KW)
    p = jfields.init_field(jax.random.key(0), cfg)
    p["sigma_head"]["b"] = p["sigma_head"]["b"] + 5.0
    ckpt = str(d / "generator.npz")
    jcommon.save_generator(ckpt, p, p, p, FLAGSHIP, step=1,
                           field_kwargs=TINY_KW)
    rng = np.random.RandomState(0)
    img_p, seg_p = str(d / "gt.png"), str(d / "seg.png")
    Image.fromarray((rng.rand(64, 64, 3) * 255).astype(np.uint8)).save(img_p)
    Image.fromarray(rng.randint(0, 19, (64, 64)).astype(np.uint8),
                    mode="L").save(seg_p)
    return ckpt, img_p, seg_p


def _args(setup, name, save_dir, *extra):
    ckpt, img_p, seg_p = setup
    return [name, "--ckpt", ckpt, "--image_path", img_p, "--seg_path",
            seg_p, "--save_dir", save_dir, "--image_size", "16",
            "--num_steps", "4", "--device", "cpu",
            *extra]


def test_inversion_runs_and_warm_starts(setup, tmp_path):
    res = main(_args(setup, "test", str(tmp_path / "inv"),
                     "--iterations", "3", "--lambda_seg", "1",
                     "--lambda_img", "1", "--eval_every", "2"))
    with np.load(res.path) as data:
        assert set(data.files) == KEYS
        assert all(np.isfinite(data[k]).all() for k in KEYS)
        moved = np.abs(data["offset_freq_geo"]).max()
        first = {k: data[k] for k in ("freq_geo", "phase_app")}
    assert moved > 0                               # the offsets were fitted
    assert res.losses.shape == (3,) and np.isfinite(res.losses).all()
    mious = np.load(str(tmp_path / "inv" / "mious.npy"))
    assert mious.shape == (2,)                     # iterations 0 and 2
    np.testing.assert_array_equal(mious, res.mious)

    # warm start: the prior run's W+offsets become the new base
    # (reference inverse_render_double_semantic.py:352-361)
    res2 = main(_args(setup, "test2", str(tmp_path / "inv2"),
                      "--iterations", "1", "--lambda_seg", "1",
                      "--lambda_img", "1", "--eval_every", "2",
                      "--load_offsets", res.path))
    with np.load(res2.path) as data2:
        np.testing.assert_array_equal(data2["w_freq_geo"], first["freq_geo"])
        np.testing.assert_array_equal(data2["w_phase_app"],
                                      first["phase_app"])


def test_lambda_percept_without_weights_fails(setup, tmp_path, monkeypatch):
    """Silently dropping the perceptual term changes the requested
    objective: it must fail unless --allow_no_lpips is passed."""
    monkeypatch.delenv("FENERF_LPIPS_WEIGHTS", raising=False)
    common = _args(setup, "test", str(tmp_path / "inv"), "--iterations",
                   "1", "--lambda_img", "1", "--lambda_percept", "0.5")
    with pytest.raises(SystemExit, match="lambda_percept"):
        main(common)
    res = main(common + ["--allow_no_lpips"])    # explicit opt-out runs
    assert os.path.exists(res.path)


def test_targets_must_be_png(setup, tmp_path):
    """Targets are JPEG or PNG, read as the JAX package's PIL path reads
    them; another format raises."""
    from fenerf_tpu.apps.invert import load_targets as jload
    from fenerf_tpu_torch.apps.invert import load_targets

    ckpt, img_p, seg_p = setup
    jpg = str(tmp_path / "gt.jpg")
    Image.open(img_p).convert("RGB").save(jpg, quality=95)
    for a, b in zip(load_targets(jpg, seg_p, 16, False),
                    jload(jpg, seg_p, 16, False)):
        np.testing.assert_array_equal(a, np.asarray(b))
    bmp = str(tmp_path / "gt.bmp")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(bmp)
    with pytest.raises(ValueError, match="not a PNG"):
        main(["x", "--ckpt", ckpt, "--image_path", bmp, "--seg_path", seg_p,
              "--save_dir", str(tmp_path), "--device", "cpu"])


def test_unported_and_device_defaults(setup, tmp_path, monkeypatch):
    """A latent-grid checkpoint is refused with the JAX package's message
    (the grid family has no W-space); the card is the default device."""
    from fenerf_tpu.nn import latent_grid_field as jlgf

    grid_kw = dict(z_dim=8, hidden_dim=16, grid_res=8, grid_ch=8, ch_max=16,
                   map_hidden_dim=16)
    gp = jlgf.init_grid_field(jax.random.key(0), jlgf.get_grid_config(
        "SPATIALSIRENGRID", **grid_kw))
    grid_ckpt = str(tmp_path / "grid.npz")
    jcommon.save_generator(grid_ckpt, gp, gp, gp, "SPATIALSIRENGRID", step=1,
                           field_kwargs=grid_kw)
    _, img_p, seg_p = setup
    with pytest.raises(SystemExit, match="requires a film-family checkpoint"):
        main(_args((grid_ckpt, img_p, seg_p), "g", str(tmp_path),
                   "--render_video"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt, img_p, seg_p = setup
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["x", "--ckpt", ckpt, "--image_path", img_p, "--seg_path",
              seg_p, "--save_dir", str(tmp_path)])


def test_render_video_matches_jax_triptych(setup, tmp_path, monkeypatch):
    """--render_video writes recon_{name}.avi: the fitted W along the
    trajectory at the eval render's settings, [rgb | seg | blend] per
    frame, each within 1 uint8 of the triptych the JAX package builds
    (fenerf_tpu/apps/invert.py:306-331) from the same W and draws."""
    from fenerf_tpu.models import generator as jgen
    from fenerf_tpu.utils.image import mask2color, to_uint8
    from fenerf_tpu_torch.apps import render_video
    from fenerf_tpu_torch.models import generator as tgen
    from fenerf_tpu_torch.utils.video import read_avi

    jp, _, _, jcfg, _ = jcommon.load_generator(setup[0])
    jr = jgen.RenderConfig(
        img_size=256, num_steps=invert.EVAL_NUM_STEPS, hierarchical=True,
        h_stddev=0.0, v_stddev=0.0, sample_dist=None,
        fill_mode="eval_seg_padding_background", ray_chunk=8192)
    key = jax.random.key(0)
    k_rays, k_c, k_pdf, k_f = jax.random.split(key, 4)
    k_perturb, _ = jax.random.split(k_rays)
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    noise = jgen.draw_ray_noise(k_c, k_pdf, k_f, 1, jr.n_rays, jr, 0.0)
    draws = tgen.RenderDraws(
        t(jax.random.uniform(k_perturb, (1, jr.n_rays, jr.num_steps))),
        None, None, tgen.RayNoise(t(noise.u), None, None))
    monkeypatch.setattr(render_video, "frame_draws", lambda *a: draws)
    res = main(_args(setup, "rv", str(tmp_path), "--iterations", "1",
                     "--lambda_seg", "1", "--eval_every", "5",
                     "--render_video", "--num_frames", "2"))
    assert res.video == str(tmp_path / "recon_rv.avi")
    frames, fps = read_avi(res.video)
    assert frames.shape == (2, 256, 3 * 256, 3) and fps == 12.0

    with np.load(res.path) as data:
        fg = (data["freq_geo"], data["phase_geo"])
        fa = (data["freq_app"], data["phase_app"])

    @jax.jit
    def render_frame(camera):
        return jgen.render(jp, jcfg, jr, key, fg, fa, batch_size=1,
                           noise_std=0.0, camera=camera)["pixels"]

    for i, (_, pitch, yaw, fov) in enumerate(
            jcommon.camera_trajectory("front", 2, 12.0)):
        pix = np.asarray(render_frame((pitch, yaw, fov)))[0]
        rgb = to_uint8(pix[-3:], normalize=False).transpose(1, 2, 0)
        seg = mask2color(pix[None, :-3])[0]
        blend = (0.5 * rgb + 0.5 * seg).astype(np.uint8)
        ref = np.concatenate([rgb, seg, blend], axis=1).astype(np.int16)
        assert np.abs(frames[i].astype(np.int16) - ref).max() <= 1, i
        assert np.ptp(ref[:, :256]) > 10        # not a blank render
