"""Port parity for free-viewpoint video: camera trajectories and film
interpolation (exact), the uncompressed AVI writer and reader, and the
render_video CLI's frames for both families against the JAX CLI's own
frames (its --save_frames PNGs) on the same latents, truncation average
and render draws. Tiny sizes (16^2, 4 + 4 steps, 3 frames)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import jax
import torch

from fenerf_tpu.apps import common as jcommon
from fenerf_tpu.models import generator as jgen
from fenerf_tpu.nn import fields as jfields
from fenerf_tpu.nn import latent_grid_field as jlgf
from fenerf_tpu_torch.apps import common as tcommon
from fenerf_tpu_torch.apps import render_video as tvideo
from fenerf_tpu_torch.models import generator as tgen
from fenerf_tpu_torch.nn import fields as tfields
from fenerf_tpu_torch.utils.video import read_avi, write_avi

torch.set_num_threads(2)

FLAGSHIP = "TextureEmbeddingPiGAN256SEMANTICDISENTANGLE_DIM_96"
FILM_KW = dict(z_geo_dim=8, z_app_dim=8, hidden_dim=16, map_hidden_dim=16,
               grid_resolution=8, grid_channels=4)
GRID = "SPATIALSIRENGRID"
GRID_KW = dict(z_dim=8, hidden_dim=16, grid_res=8, grid_ch=8, ch_max=16,
               map_hidden_dim=16)
ARGS = ["--seeds", "0", "--image_size", "16", "--num_steps", "4",
        "--num_frames", "3", "--save_frames"]
REPO = Path(__file__).resolve().parents[1]


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.mark.parametrize("name", tcommon.TRAJECTORIES)
def test_camera_trajectory_exact(name):
    for n in (1, 7, 36):
        assert tcommon.camera_trajectory(name, n, 12.0) == \
            jcommon.camera_trajectory(name, n, 12.0)
    with pytest.raises(ValueError, match="unknown trajectory"):
        tcommon.camera_trajectory("spiral", 3, 12.0)


@pytest.mark.parametrize("latent_type", ["geo", "app", "both", "non"])
def test_interpolate_films_exact(latent_type):
    rng = np.random.default_rng(1)
    f1, f2 = [tuple(rng.standard_normal((1, 12)).astype(np.float32)
                    for _ in range(2)) for _ in range(2)]
    for t in (0.0, 0.3, 0.5, 1.0):
        for which in ("geo", "app"):
            ref = jcommon.interpolate_films(
                tuple(map(jax.numpy.asarray, f1)),
                tuple(map(jax.numpy.asarray, f2)), t, latent_type, which)
            out = tcommon.interpolate_films(tuple(map(_t, f1)),
                                            tuple(map(_t, f2)), t,
                                            latent_type, which)
            for a, b in zip(ref, out):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _frames(seed=0, n=4, h=7, w=13):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def test_avi_roundtrip_exact(tmp_path):
    """Odd width (rows padded to 4 bytes) and an odd frame size (chunks
    padded to 2 bytes)."""
    frames = _frames()
    path = str(tmp_path / "v.avi")
    write_avi(path, frames, fps=12)
    back, fps = read_avi(path)
    assert fps == 12.0 and back.shape == (4, 7, 13, 3)
    np.testing.assert_array_equal(back, np.stack(frames))
    with open(path, "rb") as f:
        head = f.read(12)
    assert head[:4] == b"RIFF" and head[8:] == b"AVI "
    assert int.from_bytes(head[4:8], "little") + 8 == os.path.getsize(path)
    with pytest.raises(ValueError, match="uint8"):
        write_avi(path, [frames[0], frames[1][:5]], fps=12)


def test_avi_reads_in_cv2(tmp_path):
    """cv2.VideoCapture (FFmpeg) decodes the same frames. Run in a child
    process: a decoder fault must fail this test, not the worker."""
    pytest.importorskip("cv2")
    frames = _frames(seed=2, n=3, h=9, w=14)
    path = str(tmp_path / "v.avi")
    write_avi(path, frames, fps=10)
    out = str(tmp_path / "cv2.npy")
    code = ("import cv2, numpy as np, sys\n"
            "cap = cv2.VideoCapture(sys.argv[1]); fr = []\n"
            "fps = cap.get(cv2.CAP_PROP_FPS)\n"
            "while True:\n"
            "    ok, im = cap.read()\n"
            "    if not ok: break\n"
            "    fr.append(im[..., ::-1])\n"
            "np.save(sys.argv[2], np.stack(fr)); print(fps)\n")
    res = subprocess.run([sys.executable, "-c", code, path, out],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert float(res.stdout.split()[-1]) == 10.0
    np.testing.assert_array_equal(np.load(out), np.stack(frames))


# ---------------------------------------------------------------------------
# the CLI against the JAX CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Tiny checkpoints of both families, written by the JAX package, sigma
    bias +5 (an opaque volume)."""
    d = tmp_path_factory.mktemp("video")
    cfg = jfields.get_config(FLAGSHIP, **FILM_KW)
    p = jfields.init_field(jax.random.key(0), cfg)
    p["sigma_head"]["b"] = p["sigma_head"]["b"] + 5.0
    film = str(d / "film.npz")
    jcommon.save_generator(film, p, p, p, FLAGSHIP, step=1,
                           field_kwargs=FILM_KW)
    gcfg = jlgf.get_grid_config(GRID, **GRID_KW)
    gp = jlgf.init_grid_field(jax.random.key(1), gcfg)
    gp["sigma_head"]["b"] = gp["sigma_head"]["b"] + 5.0
    grid = str(d / "grid.npz")
    jcommon.save_generator(grid, gp, gp, gp, GRID, step=1,
                           field_kwargs=GRID_KW)
    return {"film": (film, cfg, p), "grid": (grid, gcfg, gp)}


def _replay_jax(monkeypatch, family, cfg, p, rcfg_kw):
    """Give the port the JAX CLI's latents (jax.random from the seed), its
    truncation average (key 42) and its render draws (key 0)."""
    def latents(seed, _cfg, _dev):
        kg, ka = jax.random.split(jax.random.key(seed))
        return (_t(jax.random.normal(kg, (1, cfg.z_geo_dim))),
                _t(jax.random.normal(ka, (1, cfg.z_app_dim))))

    def draws(rcfg, _dev):
        jr = jgen.RenderConfig(**rcfg_kw)
        k_rays, k_c, k_pdf, k_f = jax.random.split(jax.random.key(0), 4)
        k_perturb, _ = jax.random.split(k_rays)
        jitter = jax.random.uniform(k_perturb, (1, jr.n_rays, jr.num_steps))
        noise = jgen.draw_ray_noise(k_c, k_pdf, k_f, 1, jr.n_rays, jr, 0.0)
        return tgen.RenderDraws(_t(jitter), None, None,
                                tgen.RayNoise(_t(noise.u), None, None))

    monkeypatch.setattr(tvideo, "seed_latents", latents)
    monkeypatch.setattr(tvideo, "frame_draws", draws)
    if family == "film":
        javg = jfields.avg_film(p, cfg, jax.random.key(42))
        tavg = tuple(tuple(_t(x) for x in br) for br in javg)
        monkeypatch.setattr(tfields, "avg_film", lambda *a, **k: tavg)


@pytest.mark.parametrize("family,latent", [("film", "geo"), ("grid", "geo"),
                                           ("film", "app")])
def test_cli_frames_match_jax(ckpts, tmp_path, monkeypatch, family, latent):
    from fenerf_tpu.apps.render_video import main as jmain

    ckpt, cfg, p = ckpts[family]
    common = ARGS + ["--ckpt", ckpt, "--latent_type", latent]
    jmain(common + ["--output_dir", str(tmp_path / "j")])
    _replay_jax(monkeypatch, family, cfg, p, dict(
        img_size=16, num_steps=4, hierarchical=True))
    (video,) = tvideo.main(common + ["--output_dir", str(tmp_path / "t"),
                                     "--device", "cpu"])
    panels = 4 if family == "film" else 2       # rgb | seg | blend | depth
    assert video.frames.shape == (3, 16, 16 * panels, 3)
    assert video.pixels.shape == (3, 22 if family == "film" else 3, 16, 16)
    name = f"seed0_front_{latent}"
    assert video.path == str(tmp_path / "t" / f"{name}.avi")
    back, fps = read_avi(video.path)
    assert fps == 12.0
    np.testing.assert_array_equal(back, video.frames)
    for i in range(3):
        png = f"{name}_{i:04d}.png"
        ref = np.asarray(Image.open(tmp_path / "j" / png)).astype(np.int16)
        out = np.asarray(Image.open(tmp_path / "t" / png)).astype(np.int16)
        np.testing.assert_array_equal(out, video.frames[i])
        assert np.abs(out - ref).max() <= 1, (family, i)
        assert np.ptp(ref[:, :16]) > 10          # the rgb panel is not blank
    assert not np.array_equal(video.frames[0], video.frames[1])  # it moves
    assert video.ms_per_frame > 0


def test_shard_rays_raises(ckpts, tmp_path, monkeypatch):
    """--shard_rays is ported: four strips (the CPU four times over,
    apps/common.py::visible_devices) give the plain run's frames bit for
    bit, for either family; it raises where the strips do not divide the
    rows."""
    from fenerf_tpu_torch.apps import common as tcommon

    monkeypatch.setattr(tcommon, "visible_devices", lambda dev: [dev] * 4)
    for family in ("film", "grid"):
        ckpt = ckpts[family][0]
        args = ["--ckpt", ckpt, "--image_size", "16", "--num_steps", "4",
                "--num_frames", "2", "--ray_chunk", "64", "--device", "cpu"]
        (plain,) = tvideo.main(args + ["--output_dir", str(tmp_path / "a")])
        (strips,) = tvideo.main(args + ["--output_dir", str(tmp_path / "b"),
                                        "--shard_rays"])
        assert np.array_equal(plain.frames, strips.frames), family
    odd = ["14" if a == "16" else a for a in args]
    with pytest.raises(ValueError, match="not divisible by 4 devices"):
        tvideo.main(odd + ["--output_dir", str(tmp_path / "c"),
                           "--shard_rays"])


def test_cuda_is_the_default_device(ckpts, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvideo.main(["--ckpt", ckpts["grid"][0], "--output_dir",
                     str(tmp_path)])


def test_cli_runs_as_a_module(ckpts, tmp_path):
    """python -m fenerf_tpu_torch.apps.render_video with its own draws
    (grid family, 2 frames), without JAX in the process."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy; sys.argv[0] = 'render_video';"
         "runpy.run_module('fenerf_tpu_torch.apps.render_video',"
         " run_name='__main__');"
         "assert not any(m == 'jax' for m in sys.modules)",
         "--ckpt", ckpts["grid"][0], "--output_dir", str(tmp_path),
         "--image_size", "8", "--num_steps", "4", "--num_frames", "2",
         "--trajectory", "orbit", "--latent_type", "both", "--device",
         "cpu"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr
    frames, _ = read_avi(str(tmp_path / "seed0_orbit_both.avi"))
    assert frames.shape == (2, 8, 16, 3)
