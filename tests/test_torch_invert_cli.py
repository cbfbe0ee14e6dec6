"""The port's inversion CLI on the CPU, mirroring tests/test_apps.py's
TestInvert: a tiny run with its warm start (the prior W + offsets become
the new base), the refusal of --lambda_percept without LPIPS weights, the
PNG-only targets and the options that wait for later slices. Tiny sizes
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
    jpg = str(tmp_path / "gt.jpg")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(jpg)
    ckpt, _, seg_p = setup
    with pytest.raises(ValueError, match="not a PNG"):
        main(["x", "--ckpt", ckpt, "--image_path", jpg, "--seg_path", seg_p,
              "--save_dir", str(tmp_path), "--device", "cpu"])


def test_unported_and_device_defaults(setup, tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError, match="render_video"):
        main(_args(setup, "v", str(tmp_path), "--render_video"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt, img_p, seg_p = setup
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["x", "--ckpt", ckpt, "--image_path", img_p, "--seg_path",
              seg_p, "--save_dir", str(tmp_path)])
