"""Port apps: the .npz checkpoint bridge in both directions, the render
server's endpoints and micro-batched row routing (mirroring
tests/test_apps.py's serve tests), the stdlib PNG writer, and that the port
imports no JAX."""
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fenerf_tpu.apps import common as jcommon
from fenerf_tpu.models import generator as jgen
from fenerf_tpu.nn import fields as jfields
from fenerf_tpu_torch.apps import common as tcommon
from fenerf_tpu_torch.apps import serve as tserve
from fenerf_tpu_torch.compat import jax_bridge
from fenerf_tpu_torch.models import generator as tgen
from fenerf_tpu_torch.nn import fields as tfields

torch.set_num_threads(2)

FLAGSHIP = "TextureEmbeddingPiGAN256SEMANTICDISENTANGLE_DIM_96"
TINY_KW = dict(z_geo_dim=8, z_app_dim=8, hidden_dim=16, map_hidden_dim=16,
               grid_resolution=8, grid_channels=4)
REPO = Path(__file__).resolve().parents[1]


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _jax_params(dense: bool):
    cfg = jfields.get_config(FLAGSHIP, **TINY_KW)
    p = jfields.init_field(jax.random.key(0), cfg)
    if dense:  # non-empty volume (random init renders ~zero opacity)
        p["sigma_head"]["b"] = p["sigma_head"]["b"] + 5.0
    return cfg, p


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A tiny flagship-variant checkpoint written by the JAX package."""
    path = str(tmp_path_factory.mktemp("ckpt") / "generator.npz")
    _, p = _jax_params(dense=False)
    jcommon.save_generator(path, p, jax.tree.map(lambda x: x * 0.5, p), p,
                           FLAGSHIP, step=123, field_kwargs=TINY_KW)
    return path


def _render_pair(jp, tp, jcfg, tcfg):
    """The same small render in both packages (replayed JAX draws)."""
    jr = jgen.RenderConfig(img_size=8, num_steps=4, perturb=False)
    tr = tgen.RenderConfig(img_size=8, num_steps=4, perturb=False)
    zg = np.linspace(-1, 1, 8, dtype=np.float32)[None]
    za = np.linspace(1, -1, 8, dtype=np.float32)[None]
    key = jax.random.key(1)
    ref = jgen.render_from_z(jp, jcfg, jr, key, jnp.asarray(zg),
                             jnp.asarray(za))
    k_rays, k_c, k_pdf, k_f = jax.random.split(key, 4)
    _, k_cam = jax.random.split(k_rays)
    k_h, k_v, _ = jax.random.split(k_cam, 3)
    noise = jgen.draw_ray_noise(k_c, k_pdf, k_f, 1, jr.n_rays, jr, 0.0)
    draws = tgen.RenderDraws(
        jitter=None, cam_h=_t(jax.random.normal(k_h, (1, 1))),
        cam_v=_t(jax.random.normal(k_v, (1, 1))),
        noise=tgen.RayNoise(_t(noise.u), None, None))
    out = tgen.render_from_z(tp, tcfg, tr, _t(zg), _t(za), draws=draws)
    return np.asarray(ref["pixels"]), out["pixels"].numpy()


class TestCheckpointBridge:
    def test_leaf_order_is_jax_tree_util_order(self):
        cfg, p = _jax_params(dense=False)
        tp = jax_bridge.from_numpy_tree(jax.tree.map(np.asarray, p))
        jl = jax.tree_util.tree_leaves(p)
        tl = jax_bridge.tree_leaves(tp)
        assert len(jl) == len(tl)
        for a, t in zip(jl, tl):
            np.testing.assert_array_equal(t.numpy(), np.asarray(a))
        back = jax_bridge.to_numpy_tree(tp)
        assert jax.tree_util.tree_structure(back) == \
            jax.tree_util.tree_structure(p)

    def test_jax_checkpoint_loads_and_renders_in_port(self, tmp_path):
        jcfg, jp = _jax_params(dense=True)
        path = str(tmp_path / "g.npz")
        jcommon.save_generator(path, jp, jp, jp, FLAGSHIP, step=7,
                               field_kwargs=TINY_KW)
        params, ema, ema2, tcfg, config = tcommon.load_generator(
            path, device="cpu")
        assert config["step"] == 7 and tcfg == tfields.get_config(
            FLAGSHIP, **TINY_KW)
        for a, t in zip(jax.tree_util.tree_leaves(jp),
                        jax_bridge.tree_leaves(ema2)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(a))
        ref, out = _render_pair(jp, params, jcfg, tcfg)
        assert (ref[:, -3:] > -0.99).mean() > 0.1  # something was drawn
        np.testing.assert_allclose(out, ref, atol=1e-4)

    def test_port_checkpoint_loads_and_renders_in_jax(self, tmp_path):
        tcfg = tfields.get_config(FLAGSHIP, **TINY_KW)
        tp = tfields.init_field(torch.Generator().manual_seed(3), tcfg)
        tp["sigma_head"]["b"] = tp["sigma_head"]["b"] + 5.0
        path = str(tmp_path / "g.npz")
        tcommon.save_generator(path, tp, tp, tp, FLAGSHIP, step=11,
                               field_kwargs=TINY_KW)
        jp, _, _, jcfg, config = jcommon.load_generator(path)
        assert config["step"] == 11 and config["family"] == "film"
        for a, t in zip(jax.tree_util.tree_leaves(jp),
                        jax_bridge.tree_leaves(tp)):
            np.testing.assert_array_equal(np.asarray(a), t.numpy())
        ref, out = _render_pair(jp, tp, jcfg, tcfg)
        np.testing.assert_allclose(out, ref, atol=1e-4)

    def test_loader_runs_on_the_card_unless_asked(self, monkeypatch,
                                                  tiny_ckpt):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcommon.load_generator(tiny_ckpt)
        params = tcommon.load_generator(tiny_ckpt, device="cpu")[0]
        assert all(t.device.type == "cpu"
                   for t in jax_bridge.tree_leaves(params))


def _png_pixels(body: bytes) -> np.ndarray:
    """Decode the writer's own PNG layout (8-bit RGB, filter 0)."""
    assert body[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, size = 8, b"", None
    while pos < len(body):
        n = int.from_bytes(body[pos:pos + 4], "big")
        tag, data = body[pos + 4:pos + 8], body[pos + 8:pos + 8 + n]
        crc = int.from_bytes(body[pos + 8 + n:pos + 12 + n], "big")
        assert zlib.crc32(tag + data) & 0xFFFFFFFF == crc
        if tag == b"IHDR":
            size = (int.from_bytes(data[4:8], "big"),
                    int.from_bytes(data[:4], "big"))
            assert data[8:10] == b"\x08\x02"
        elif tag == b"IDAT":
            idat += data
        pos += 12 + n
    h, w = size
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


class TestServe:
    def test_png_writer(self):
        img = np.random.default_rng(0).integers(0, 256, (5, 7, 3), np.uint8)
        np.testing.assert_array_equal(_png_pixels(tserve.encode_png(img)),
                                      img)

    def test_png_writer_bytes(self):
        """The writer's RGB layout, byte for byte: signature, IHDR (8-bit
        RGB), one IDAT of filter-0 scanlines at zlib level 6, IEND."""
        import struct

        img = np.random.default_rng(1).integers(0, 256, (6, 9, 3), np.uint8)

        def chunk(tag, data):
            return (struct.pack(">I", len(data)) + tag + data
                    + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

        raw = b"".join(b"\x00" + row.tobytes() for row in img)
        want = (b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", 9, 6, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
        assert tserve.encode_png(img) == want

    def test_depth_jet_equals_cv2(self):
        """The jet table is cv2.COLORMAP_JET's, bit for bit: all 256 levels
        and a random depth map through depth_to_jet."""
        import cv2

        from fenerf_tpu_torch.utils.image import JET, depth_to_jet

        levels = np.arange(256, dtype=np.uint8)[:, None]
        ref = cv2.applyColorMap(levels, cv2.COLORMAP_JET)[:, 0, ::-1]
        np.testing.assert_array_equal(JET, ref)
        depth = np.random.default_rng(2).uniform(0.85, 1.15, (33, 47))
        d = np.clip((depth - 0.88) / 0.24, 0, 1)
        ref = cv2.applyColorMap((d * 255).astype(np.uint8),
                                cv2.COLORMAP_JET)[..., ::-1]
        np.testing.assert_array_equal(depth_to_jet(depth), ref)

    def test_cuda_device_raises_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tserve.resolve_device("cuda")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tserve.main(["--ckpt", "unused.npz"])

    def test_render_server_endpoints(self, tiny_ckpt):
        render_np, meta = tserve.build_renderer(
            tiny_ckpt, image_size=16, num_steps=2, ray_step_multiplier=1,
            fov=12.0, fill_mode="seg_padding_background", fill_color="black",
            ray_chunk=0, use_ema=True, device="cpu")
        assert meta["step"] == 123 and meta["n_labels"] > 0
        assert meta["backend"] == "torch"
        srv = tserve.make_server(render_np, meta, port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            def get(path):
                return urllib.request.urlopen(base + path, timeout=120)

            assert json.loads(get("/healthz").read())["ok"] is True
            assert json.loads(get("/meta").read())["image_size"] == 16
            assert get("/").read().startswith(b"<!doctype html>")
            for kind in ("rgb", "seg", "depth"):
                r = get(f"/render?seed=3&yaw=0.2&psi=0.5&kind={kind}")
                body = r.read()
                assert _png_pixels(body).shape == (16, 16, 3), kind
                assert float(r.headers["X-Render-Ms"]) > 0
            a = get("/render?seed=3&yaw=0.2").read()
            b = get("/render?seed=3&yaw=0.2").read()
            assert a == b  # same request, same bytes
            with pytest.raises(urllib.error.HTTPError) as ei:
                get("/render?seed=notanint")
            assert ei.value.code == 400
            with pytest.raises(urllib.error.HTTPError) as ei:
                get("/nope")
            assert ei.value.code == 404
            assert json.loads(get("/healthz").read())["ok"] is True
        finally:
            srv.shutdown()
            srv.server_close()

    def test_micro_batched_server_routes_rows(self, tiny_ckpt, tmp_path):
        render_np, meta = tserve.build_renderer(
            tiny_ckpt, image_size=16, num_steps=2, ray_step_multiplier=1,
            fov=12.0, fill_mode="seg_padding_background", fill_color="black",
            ray_chunk=0, use_ema=True, batch=4, batch_wait_ms=30.0,
            device="cpu")
        assert meta["batch"] == 4
        srv = tserve.make_server(render_np, meta, port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"

        def get(i):
            url = (f"{base}/render?seed={i}&yaw={0.1 * i}&pitch={0.02 * i}"
                   f"&psi={0.5 + 0.1 * (i % 3)}")
            with urllib.request.urlopen(url, timeout=300) as r:
                return _png_pixels(r.read())

        try:  # one full batch and one partial batch
            with ThreadPoolExecutor(max_workers=6) as ex:
                assert len(list(ex.map(get, range(6)))) == 6
        finally:
            srv.shutdown()
            srv.server_close()

        # row routing: each concurrent request gets ITS render. A dense
        # volume and the raw composite (fill_mode=None); every request is
        # compared with the same request rendered alone.
        _, jp = _jax_params(dense=True)
        dense = str(tmp_path / "dense.npz")
        jcommon.save_generator(dense, jp, jp, jp, FLAGSHIP, step=1,
                               field_kwargs=TINY_KW)
        kw = dict(image_size=16, num_steps=2, ray_step_multiplier=1,
                  fov=12.0, fill_mode=None, fill_color="black", ray_chunk=0,
                  use_ema=True, device="cpu")
        render_raw, _ = tserve.build_renderer(dense, batch=4,
                                              batch_wait_ms=200.0, **kw)
        single, _ = tserve.build_renderer(dense, **kw)
        reqs = [(i, 0.1 * i, 0.02 * i, 0.5 + 0.1 * i) for i in range(4)]
        with ThreadPoolExecutor(max_workers=4) as ex:
            outs = list(ex.map(lambda q: render_raw(*q)[0], reqs))
        assert any(np.abs(outs[0] - o).max() > 1e-3 for o in outs[1:])
        for q, o in zip(reqs, outs):
            # perturb draws depend on the row, so compare loosely: a
            # misrouted row differs by far more
            np.testing.assert_allclose(o, single(*q)[0], atol=0.05)


def test_grid_request_to_the_server(tmp_path):
    """A latent-grid checkpoint (written by the JAX package) served by the
    port: RGB from the request's z on the torch route for the field and
    the rays (as the JAX package serves it on XLA), the same pixels as a
    direct render_grid_from_z of that z, and seg falling back to RGB."""
    from fenerf_tpu.nn import latent_grid_field as jlgf

    grid_kw = dict(z_dim=8, hidden_dim=16, grid_res=8, grid_ch=8, ch_max=16,
                   map_hidden_dim=16)
    gp = jlgf.init_grid_field(jax.random.key(1), jlgf.get_grid_config(
        "SPATIALSIRENGRID", **grid_kw))
    gp["sigma_head"]["b"] = gp["sigma_head"]["b"] + 5.0
    ckpt = str(tmp_path / "grid.npz")
    jcommon.save_generator(ckpt, gp, gp, gp, "SPATIALSIRENGRID", step=3,
                           field_kwargs=grid_kw)
    render_np, meta = tserve.build_renderer(
        ckpt, image_size=16, num_steps=3, ray_step_multiplier=1, fov=12.0,
        fill_mode="seg_padding_background", fill_color="black", ray_chunk=0,
        use_ema=True, device="cpu")
    assert meta["family"] == "grid" and meta["n_labels"] == 0
    assert meta["backend"] == "torch" and meta["ray_route"] == "torch"
    srv = tserve.make_server(render_np, meta, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        def get(q):
            with urllib.request.urlopen(f"{base}/render?{q}", timeout=120) as r:
                return r.read()

        rgb = get("seed=3&yaw=0.2&pitch=-0.05&kind=rgb")
        assert get("seed=3&yaw=0.2&pitch=-0.05&kind=seg") == rgb
        assert _png_pixels(get("seed=3&kind=depth")).shape == (16, 16, 3)
    finally:
        srv.shutdown()
        srv.server_close()
    params, _, _, cfg, _ = tcommon.load_generator(ckpt, device="cpu")
    zg, _ = tserve._seed_latents(3, cfg)
    rcfg = tgen.RenderConfig(img_size=16, num_steps=3, fov=12.0,
                             fill_mode="eval_white_back",
                             compute_dtype="bfloat16")
    pix = tgen.render_grid_from_z(
        params, cfg, rcfg, torch.from_numpy(zg[None]),
        camera=(np.pi / 2 + torch.tensor([[-0.05]]),
                np.pi / 2 + torch.tensor([[0.2]]), 12.0),
        generator=torch.Generator().manual_seed(0))["pixels"][0].numpy()
    want = np.clip((pix[-3:] + 1) / 2 * 255 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(_png_pixels(rgb), want.transpose(1, 2, 0))
    assert np.ptp(want) > 10

def test_port_imports_no_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "import fenerf_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'fenerf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'PIL', 'cv2')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules"
        " if m.startswith('fenerf_tpu_torch')]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok ")
