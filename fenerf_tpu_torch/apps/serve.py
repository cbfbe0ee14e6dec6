"""Persistent render server on the port (counterpart of
fenerf_tpu/apps/serve.py, both families).

Loads a generator checkpoint ONCE onto the device, builds the texture
table and the fused kernel's operands once, then answers HTTP requests:

  GET /                 tiny interactive page (seed / yaw / pitch / psi)
  GET /render?seed=0&yaw=0&pitch=0&psi=0.7&kind=rgb|seg|depth   -> image/png
  GET /meta             model/config JSON
  GET /healthz          liveness probe -> {"ok": true}

Device work is serialized with a lock; --batch N > 1 instead queues
concurrent requests and renders up to N of them in one batch (per-request
camera and psi). PNGs are encoded with a stdlib zlib writer
(utils/image.py::encode_png). A latent-grid checkpoint serves RGB from z
(psi is not read: no W truncation) on the torch route for the field and
the rays, as the JAX package serves it on XLA.

Usage:
  python -m fenerf_tpu_torch.apps.serve --ckpt output/run/generator.npz \
      [--port 8798] [--image_size 128] [--num_steps 24] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from fenerf_tpu_torch.utils.image import encode_png

_PAGE = """<!doctype html>
<html><head><title>FENeRF render server</title><style>
body { font-family: sans-serif; margin: 16px; background: #222; color: #eee }
input { width: 70px } img { border: 1px solid #888; margin: 4px }
</style></head><body>
<h3>FENeRF render server</h3>
<div>
 seed <input id="seed" type="number" value="0">
 yaw <input id="yaw" type="number" value="0" step="0.1">
 pitch <input id="pitch" type="number" value="0" step="0.05">
 psi <input id="psi" type="number" value="0.7" step="0.1">
 <button onclick="go()">render</button> <span id="ms"></span>
</div>
<div><img id="rgb"><img id="seg"></div>
<script>
function go() {
  const q = ['seed','yaw','pitch','psi']
    .map(k => k + '=' + document.getElementById(k).value).join('&');
  const t0 = performance.now();
  const rgb = document.getElementById('rgb');
  rgb.onload = () => document.getElementById('ms').textContent =
      Math.round(performance.now() - t0) + ' ms';
  rgb.src = 'render?kind=rgb&' + q + '&t=' + Date.now();
  document.getElementById('seg').src = 'render?kind=seg&' + q + '&t=' + Date.now();
}
go();
</script></body></html>"""


def resolve_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but CUDA is not available")
    return dev


def build_renderer(ckpt: str, image_size: int, num_steps: int,
                   ray_step_multiplier: int, fov: float, fill_mode: str,
                   fill_color: str, ray_chunk: int, use_ema: bool,
                   batch: int = 1, batch_wait_ms: float = 5.0,
                   device: str = "cuda"):
    """-> (render_np(seed, yaw, pitch, psi) -> ((C,H,W), (H,W)) arrays, meta).

    Every render draws from a generator seeded 0, so the same request gives
    the same pixels. batch > 1 enables micro-batching (see _make_batcher);
    a request's draws then depend on its row in the batch."""
    from fenerf_tpu_torch.apps.common import best_backend, load_generator
    from fenerf_tpu_torch.models import generator as gen
    from fenerf_tpu_torch.nn import fields
    from fenerf_tpu_torch.ops import film_mlp

    dev = resolve_device(device)
    params, ema, _, fcfg, config = load_generator(ckpt, device=dev)
    if use_ema:
        params = ema
    is_grid = config["family"] == "grid"
    if is_grid and fill_mode == "seg_padding_background":
        fill_mode = "eval_white_back"   # the grid family is RGB-only
    steps = num_steps * ray_step_multiplier
    rcfg = gen.RenderConfig(
        img_size=image_size, num_steps=steps, hierarchical=True,
        perturb=True, fill_mode=fill_mode, fill_color=fill_color, fov=fov,
        ray_chunk=ray_chunk, compute_dtype="bfloat16",
        backend="torch" if is_grid else best_backend(fcfg, dev))
    if not is_grid:
        # derived operands once per loaded checkpoint, not per request
        params = fields.with_grid_table(params, fcfg, torch.bfloat16)
        if rcfg.backend == "kernel":
            params = film_mlp.with_pack(params, fcfg)
        avg = fields.avg_film(params, fcfg,
                              torch.Generator(device=dev).manual_seed(42))

    @torch.inference_mode()
    def render_many(z_geo, z_app, pitch, yaw, psi):
        """numpy (B, z) latents and (B, 1) pitch / yaw / psi -> numpy
        pixels (B, C, H, W) and depth (B, H, W)."""
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        camera = (math.pi * 0.5 + t(pitch), math.pi * 0.5 + t(yaw), fov)
        g = torch.Generator(device=dev).manual_seed(0)
        if is_grid:
            out = gen.render_grid_from_z(params, fcfg, rcfg, t(z_geo),
                                         camera=camera, generator=g)
        else:
            out = gen.render_truncated(
                params, fcfg, rcfg, t(z_geo), t(z_app), avg, psi=t(psi),
                noise_std=0.0, camera=camera, generator=g)
        return out["pixels"].cpu().numpy(), out["depth"].cpu().numpy()

    ray_route, ray_why = gen.ray_route(rcfg, dev)
    meta = {"model": config.get("model"), "family": config.get("family"),
            "step": config.get("step"), "image_size": image_size,
            "num_steps": steps, "n_labels": int(fcfg.n_labels),
            "ema": bool(use_ema), "backend": rcfg.backend,
            "ray_route": ray_route, "ray_route_why": ray_why,
            "device": str(dev)}
    if batch > 1:
        meta["batch"] = batch
        return _make_batcher(render_many, fcfg, batch, batch_wait_ms), meta

    def render_np(seed: int, yaw: float, pitch: float, psi: float):
        zg, za = _seed_latents(seed, fcfg)
        pix, depth = render_many(zg[None], za[None], [[pitch]], [[yaw]],
                                 [[psi]])
        return pix[0], depth[0]

    return render_np, meta


def _seed_latents(seed: int, fcfg):
    """Deterministic per-seed latents, drawn on the host with numpy (the
    same draws as the JAX package's server)."""
    rng = np.random.default_rng(int(seed))
    zg = rng.standard_normal(fcfg.z_geo_dim).astype(np.float32)
    za = rng.standard_normal(fcfg.z_app_dim).astype(np.float32)
    return zg, za


def _make_batcher(render_many, fcfg, batch: int, wait_ms: float):
    """Micro-batching collector: requests enqueue; a dispatcher thread
    drains up to `batch` of them (waiting at most wait_ms for stragglers
    after the first) and renders them in one batch. Returns
    render_np(seed, yaw, pitch, psi), which blocks until its row is ready,
    so the HTTP handler does not know about batching."""
    import queue

    q: "queue.Queue" = queue.Queue()

    def worker():
        while True:
            items = [q.get()]
            deadline = time.perf_counter() + wait_ms / 1e3
            while len(items) < batch:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    items.append(q.get(timeout=left))
                except queue.Empty:
                    break
            n = len(items)
            zg = np.zeros((n, fcfg.z_geo_dim), np.float32)
            za = np.zeros((n, fcfg.z_app_dim), np.float32)
            cam = np.zeros((n, 3), np.float32)  # pitch, yaw, psi
            for i, (req, _slot) in enumerate(items):
                zg[i], za[i], cam[i] = req
            try:
                pix, depth = render_many(zg, za, cam[:, 0:1], cam[:, 1:2],
                                         cam[:, 2:3])
                for i, (_req, slot) in enumerate(items):
                    slot["out"] = (pix[i], depth[i])
                    slot["event"].set()
            except Exception as e:  # deliver the failure, don't wedge callers
                for _req, slot in items:
                    slot["error"] = e
                    slot["event"].set()

    threading.Thread(target=worker, daemon=True).start()

    def render_np(seed: int, yaw: float, pitch: float, psi: float):
        zg, za = _seed_latents(seed, fcfg)
        slot = {"event": threading.Event()}
        q.put(((zg, za, np.asarray([pitch, yaw, psi], np.float32)), slot))
        slot["event"].wait()
        if "error" in slot:
            raise slot["error"]
        return slot["out"]

    return render_np


def make_server(render_np, meta, port: int = 8798, host: str = "127.0.0.1"):
    import contextlib

    from fenerf_tpu_torch.utils.image import depth_to_jet, mask2color, to_uint8

    # batched mode: the batcher's worker owns all device work, so handlers
    # run concurrently (a lock would feed it one request at a time)
    lock = (contextlib.nullcontext() if meta.get("batch", 1) > 1
            else threading.Lock())

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype, headers=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(u.query).items()}
            if u.path == "/":
                self._send(200, _PAGE.encode(), "text/html")
            elif u.path == "/healthz":
                self._send(200, b'{"ok": true}', "application/json")
            elif u.path == "/meta":
                self._send(200, json.dumps(meta).encode(), "application/json")
            elif u.path == "/render":
                try:
                    seed = int(q.get("seed", "0"))
                    yaw = float(q.get("yaw", "0"))
                    pitch = float(q.get("pitch", "0"))
                    psi = float(q.get("psi", "0.7"))
                    kind = q.get("kind", "rgb")
                    t0 = time.perf_counter()
                    with lock:
                        pix, depth = render_np(seed, yaw, pitch, psi)
                    if kind == "seg" and meta["n_labels"]:
                        img = mask2color(pix[None, :-3])[0]
                    elif kind == "depth":
                        img = depth_to_jet(depth)
                    else:
                        # fixed [-1,1] -> [0,255] mapping, no per-frame min-max
                        img = to_uint8(pix[None, -3:],
                                       normalize=False)[0].transpose(1, 2, 0)
                    body = encode_png(img)
                    ms = (time.perf_counter() - t0) * 1e3
                    self._send(200, body, "image/png",
                               (("X-Render-Ms", f"{ms:.1f}"),))
                except Exception as e:  # bad query -> 400, not a dead server
                    self._send(400, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode(),
                        "application/json")
            else:
                self._send(404, b"not found", "text/plain")

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True)
    p.add_argument("--port", type=int, default=8798)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--num_steps", type=int, default=24)
    p.add_argument("--ray_step_multiplier", type=int, default=2)
    p.add_argument("--fov", type=float, default=12.0)
    p.add_argument("--fill_mode", default="seg_padding_background")
    p.add_argument("--fill_color", default="black",
                   choices=["black", "white", "grey", "light_grey"])
    p.add_argument("--ray_chunk", type=int, default=4096)
    p.add_argument("--use_ema", action="store_true", default=True)
    p.add_argument("--no_ema", dest="use_ema", action="store_false")
    p.add_argument("--batch", type=int, default=1,
                   help="micro-batch size: >1 renders queued concurrent "
                        "requests together (per-request camera/psi)")
    p.add_argument("--batch_wait_ms", type=float, default=5.0,
                   help="how long the batcher waits for stragglers after "
                        "the first queued request")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (raises if CUDA is "
                        "requested and absent)")
    args = p.parse_args(argv)

    render_np, meta = build_renderer(
        args.ckpt, args.image_size, args.num_steps, args.ray_step_multiplier,
        args.fov, args.fill_mode, args.fill_color, args.ray_chunk,
        args.use_ema, batch=args.batch, batch_wait_ms=args.batch_wait_ms,
        device=args.device)
    print(f"[serve] ray route: {meta['ray_route']} ({meta['ray_route_why']})")
    t0 = time.perf_counter()
    render_np(0, 0.0, 0.0, 0.7)  # build the kernel and warm before traffic
    print(f"warmed in {time.perf_counter() - t0:.1f}s "
          f"({meta['model']}, step {meta['step']}, {meta['backend']})")
    srv = make_server(render_np, meta, port=args.port, host=args.host)
    print(f"serving on http://{args.host}:{srv.server_address[1]}")
    srv.serve_forever()


if __name__ == "__main__":
    main()
