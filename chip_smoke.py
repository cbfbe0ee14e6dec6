"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Drives the port's two main paths at the full width of the flagship model
TextureEmbeddingPiGAN256SEMANTICDISENTANGLE_DIM_96 with random weights from
a seed: serving (fenerf_tpu_torch.apps.serve) through the hand-written CUDA
field kernel (ops/csrc/film_mlp.cu), and GAN training
(fenerf_tpu_torch.train.loop) through it and the hand-written backward
kernels (ops/csrc/film_mlp_bwd.cu), all built here from the checkout.

Phases (any failure exits non-zero):
  1. card and build: card name and power limit, torch / CUDA versions,
     both kernel libraries built in parallel (one nvcc each);
  2. the forward kernel against its plain torch version at the serving
     shape (B=1, N=4096x48), a ragged one (N not a multiple of the tile)
     and the training renders' shape (B=6, N=32x32x24), max |diff| and the
     time of each side;
  3. serving: a full-width .npz checkpoint, build_renderer at the serve
     defaults, HTTP rgb / seg requests on a batch-1 server and 6 concurrent
     requests on a --batch 4 server; the kernel must be launched and the
     plain version never called; ms/request and rays/s;
  4. one whole render through the kernel against the same render through
     the plain version, and ray-chunked against whole-image rendering;
  5. the backward kernels against their plain version at the G-phase shape
     (B=6, N=32x32x24) and a ragged one, per output group
     (ops/film_mlp_grad.py::bwd_agreement), and their times;
  6. training: stage 0 of the flagship curriculum (bs 24, split 4, 32^2,
     24+24 steps), TRAIN_STEPS steps on seeded synthetic reals; finite
     losses, ms/step (median after the first), images/s, both kernels
     launched and no plain version called;
  7. G's gradient through the kernels against the torch route (bf16): the
     field's vector-Jacobian product at the G shape, held to the JAX
     package's criterion; and, printed as context, whole G-microbatch
     render gradients at the initial and the trained state.

Prints the card line, a JSON line of per-kernel results and, last,
{"ok": true, "device": {...}}. Exits non-zero without CUDA.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import torch

FLAGSHIP = "TextureEmbeddingPiGAN256SEMANTICDISENTANGLE_DIM_96"
# kernel vs plain version: both round every matmul operand to bf16 and
# accumulate in f32; they differ in summation order only (bf16 level, as
# the JAX package's kernel test, tests/test_film_mlp_kernel.py:55)
KERNEL_TOL = 2e-2
# whole render, kernel field vs plain-version field, pixels in [-1, 1]: the
# field difference above, passed through importance sampling and
# compositing
RENDER_TOL = 2e-2
SERVE = dict(image_size=128, num_steps=24, ray_step_multiplier=2, fov=12.0,
             fill_mode="seg_padding_background", fill_color="black",
             ray_chunk=4096, use_ema=True)
SIGMA_BIAS = 20.0   # makes the random volume opaque (as tests/test_apps.py)
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms (CUDA events, after warm-up)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_card():
    from fenerf_tpu_torch.ops import build, film_mlp, film_mlp_grad

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.build(["film_mlp", "film_mlp_bwd"])
    film_mlp._load_library()
    film_mlp_grad._load_library()
    log(f"[build] film_mlp and film_mlp_bwd ready in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, out in build.BUILD_LOG.items():
        log(f"[build] {name}:\n{out.strip()}")


def _flagship_params(dev, seed=0):
    from fenerf_tpu_torch.nn import fields

    cfg = fields.get_config(FLAGSHIP)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = fields.init_field(gen, cfg, device=dev)
    params["sigma_head"]["b"] = params["sigma_head"]["b"] + SIGMA_BIAS
    return cfg, params, gen


# the forward kernel's shapes: serving (B=1, N=128^2 x 48 steps), a ragged
# batch (N not a multiple of the tile), and training's renders (a microbatch
# of 6 of the stage's 24 fakes, N=32^2 x 24 steps: D fakes and G forward)
FWD_SHAPES = ((1, 4096 * 48), (4, 12345), (6, 32 * 32 * 24))


def phase_kernel(dev) -> dict:
    """The forward kernel against its plain version at FWD_SHAPES. Returns
    the serving shape's times and bound, the worst error over all shapes,
    and each shape's numbers under "shapes"."""
    from fenerf_tpu_torch.nn import fields
    from fenerf_tpu_torch.ops import film_mlp

    cfg, params, gen = _flagship_params(dev)
    params = fields.with_grid_table(params, cfg, torch.bfloat16)
    pack = film_mlp.pack(params, cfg)
    shapes = []
    for b, n in FWD_SHAPES:
        # points inside the box the rays sample (z in [0.88, 1.12])
        pts = (torch.rand(b, n, 3, generator=gen, device=dev) - 0.5) * 0.24
        dirs = torch.nn.functional.normalize(
            torch.randn(b, n, 3, generator=gen, device=dev), dim=-1)
        zg = torch.randn(b, cfg.z_geo_dim, generator=gen, device=dev)
        za = torch.randn(b, cfg.z_app_dim, generator=gen, device=dev)
        fg, fa = fields.field_film(params, cfg, zg, za)
        warped = pts * (2.0 / cfg.box_side)
        gf = fields._grid_feats(params, warped, torch.bfloat16)
        args = (pack, warped, dirs, gf, fg, fa)
        out = film_mlp.film_mlp(*args)
        ref = film_mlp.film_mlp_reference(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError("kernel output is not finite")
        err = (out - ref).abs().max().item()
        ms = time_ms(lambda: film_mlp.film_mlp(*args), iters=10)
        plain_ms = time_ms(lambda: film_mlp.film_mlp_reference(*args),
                           iters=3, warmup=1)
        rows = b * n
        bound, by = bound_ms(
            rows * _flops_per_point(cfg),
            rows * (4 * 3 + 4 * 3 + 2 * cfg.grid_channels
                    + 4 * cfg.output_dim) + pack.weights.numel() * 2)
        log(f"[kernel] B={b} N={n} rows={rows} max|kernel-plain|={err:.3e} "
            f"(tol {KERNEL_TOL}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
            f"kernel {rows / ms / 1e3:.1f} Mpts/s "
            f"{rows * _flops_per_point(cfg) / ms / 1e9:.1f} TFLOP/s, "
            f"bound {bound:.3f} ms ({by})")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"kernel disagrees with plain version: {err}")
        shapes.append({"B": b, "N": n, "max_abs_err": err, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": by})
    return {**shapes[0], "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "library_ms": None, "shapes": shapes}


# NVIDIA H100 SXM data sheet, dense, at the full 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations
    over the bf16 tensor-core peak and the bytes over the memory rate."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _flops_per_point(cfg) -> int:
    """Matmul FLOPs of the folded field per point (unpadded shapes)."""
    h, g = cfg.hidden_dim, cfg.grid_channels
    k = (3 * h + (cfg.trunk_layers - 1) * h * h                   # trunk
         + h * (1 + cfg.n_labels)                                 # heads
         + (3 + g + h) * h + (cfg.color_layers - 1) * h * h       # color
         + h * cfg.rgb_dim)
    return 2 * k


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=600) as r:
        if r.status != 200:
            raise AssertionError(f"{url}: HTTP {r.status}")
        return r.read()


def _serve(render_np, meta):
    from fenerf_tpu_torch.apps.serve import make_server

    srv = make_server(render_np, meta, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def phase_serve(dev, tmp) -> int:
    from fenerf_tpu_torch.apps.common import save_generator
    from fenerf_tpu_torch.apps.serve import build_renderer
    from fenerf_tpu_torch.ops import film_mlp

    cfg, params, _ = _flagship_params(dev, seed=1)
    ckpt = os.path.join(tmp, "generator.npz")
    t0 = time.perf_counter()
    save_generator(ckpt, params, params, params, FLAGSHIP, step=0)
    log(f"[serve] wrote full-width checkpoint "
        f"({os.path.getsize(ckpt) / 2**20:.0f} MiB) in "
        f"{time.perf_counter() - t0:.1f} s")
    del params
    rays = SERVE["image_size"] ** 2

    # --- the main path: counts from zero ---
    film_mlp.film_mlp.launches = 0
    film_mlp.film_mlp_reference.calls = 0

    render_np, meta = build_renderer(ckpt, device="cuda", **SERVE)
    if meta["backend"] != "kernel":
        raise AssertionError(f"serving backend is {meta['backend']}")
    t0 = time.perf_counter()
    render_np(0, 0.0, 0.0, 0.7)
    log(f"[serve] batch-1 warm-up render {time.perf_counter() - t0:.2f} s")
    srv, base = _serve(render_np, meta)
    try:
        assert json.loads(_get(base + "/healthz"))["ok"] is True
        for kind in ("rgb", "seg"):
            body = _get(f"{base}/render?seed=3&yaw=0.2&psi=0.5&kind={kind}")
            assert body[:8] == PNG_MAGIC, kind
        a = _get(f"{base}/render?seed=5&yaw=-0.1&pitch=0.05")
        b = _get(f"{base}/render?seed=5&yaw=-0.1&pitch=0.05")
        assert a == b, "same request gave different bytes"
        n_req = 5
        t0 = time.perf_counter()
        for i in range(n_req):
            assert _get(f"{base}/render?seed={i}&yaw={0.1 * i}")[:8] \
                == PNG_MAGIC
        dt = (time.perf_counter() - t0) / n_req
        log(f"[serve] batch 1: {n_req} sequential rgb requests, "
            f"{dt * 1e3:.1f} ms/request, {rays / dt:.0f} rays/s "
            f"({SERVE['image_size']}^2, "
            f"{SERVE['num_steps']}x{SERVE['ray_step_multiplier']} steps)")
    finally:
        srv.shutdown()
        srv.server_close()

    render_b, meta_b = build_renderer(ckpt, device="cuda", batch=4,
                                      batch_wait_ms=50.0, **SERVE)
    render_b(0, 0.0, 0.0, 0.7)  # warm-up
    srv, base = _serve(render_b, meta_b)
    try:
        def get(i):
            return _get(f"{base}/render?seed={i}&yaw={0.1 * i}"
                        f"&pitch={0.02 * i}&psi={0.5 + 0.1 * (i % 3)}")

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=6) as ex:
            bodies = list(ex.map(get, range(6)))
        dt = time.perf_counter() - t0
        assert all(x[:8] == PNG_MAGIC for x in bodies)
        assert len(set(bodies)) > 1, "batched rows were not routed"
        log(f"[serve] batch 4: 6 concurrent requests in {dt * 1e3:.1f} ms, "
            f"{dt / 6 * 1e3:.1f} ms/request, {6 * rays / dt:.0f} rays/s")
    finally:
        srv.shutdown()
        srv.server_close()

    launches = film_mlp.film_mlp.launches
    plain = film_mlp.film_mlp_reference.calls
    log(f"[serve] film_mlp kernel launches {launches}, "
        f"plain version calls {plain}")
    if launches <= 0 or plain != 0:
        raise AssertionError("serving did not run through the kernel alone")
    log(f"[serve] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def phase_render(dev):
    from fenerf_tpu_torch.models import generator as gen
    from fenerf_tpu_torch.nn import fields
    from fenerf_tpu_torch.ops import film_mlp

    cfg, params, g = _flagship_params(dev, seed=2)
    params = film_mlp.with_pack(
        fields.with_grid_table(params, cfg, torch.bfloat16), cfg)
    zg = torch.randn(1, cfg.z_geo_dim, generator=g, device=dev)
    za = torch.randn(1, cfg.z_app_dim, generator=g, device=dev)
    avg = fields.avg_film(params, cfg,
                          torch.Generator(device=dev).manual_seed(42))
    fg, fa = fields.field_film(params, cfg, zg, za)
    fg = fields.truncate_film(fg, avg[0], 0.7)
    fa = fields.truncate_film(fa, avg[1], 0.7)
    steps = SERVE["num_steps"] * SERVE["ray_step_multiplier"]
    camera = (math.pi / 2, math.pi / 2 + 0.2, SERVE["fov"])

    def render(chunk, plain=False):
        rcfg = gen.RenderConfig(
            img_size=SERVE["image_size"], num_steps=steps, fov=SERVE["fov"],
            fill_mode=SERVE["fill_mode"], ray_chunk=chunk,
            compute_dtype="bfloat16", backend="kernel")
        field_fn = gen._film_field_fn(params, cfg, rcfg, fg, fa)
        if plain:   # the same fused field through its plain version
            pack = params[film_mlp.PACK_KEY]

            def field_fn(pts, drs):
                warped = pts * (2.0 / cfg.box_side)
                gf = fields._grid_feats(params, warped, torch.bfloat16)
                return film_mlp.film_mlp_reference(pack, warped, drs, gf,
                                                   fg, fa)
        out = gen.render_core(
            field_fn, cfg.output_dim, rcfg, 1, camera=camera,
            generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        torch.cuda.synchronize()
        return out

    kern = render(SERVE["ray_chunk"])
    plain = render(SERVE["ray_chunk"], plain=True)
    whole = render(0)
    px = kern["pixels"]
    if not (torch.isfinite(px).all() and px.shape == (
            1, cfg.n_labels + 1 + 3, SERVE["image_size"],
            SERVE["image_size"])):
        raise AssertionError(f"bad render {tuple(px.shape)}")
    opacity = kern["opacity"].mean().item()
    err = (px - plain["pixels"]).abs().max().item()
    chunk_err = (px - whole["pixels"]).abs().max().item()
    log(f"[render] mean opacity {opacity:.3f}; max|kernel-plain| pixel "
        f"{err:.3e} (tol {RENDER_TOL}); ray_chunk {SERVE['ray_chunk']} vs "
        f"whole image max|diff| {chunk_err:.3e} "
        f"(bit-exact: {torch.equal(px, whole['pixels'])})")
    if not err <= RENDER_TOL:
        raise AssertionError(f"kernel render disagrees with plain: {err}")
    if not torch.equal(px, whole["pixels"]):
        raise AssertionError("ray-chunked render differs from whole image")


# G's gradient, kernel route against the torch route at bf16: the JAX
# package's own criterion (tests/test_film_mlp_kernel.py:159-185)
GRAD_COS, GRAD_NORM = 0.999, 0.02
TEXTURE = "CelebA_double_semantic_texture_embedding_256_dim_96"
TRAIN_STEPS = 6     # the first is warm-up; ms/step is the median of the rest


def _macs_per_point_unfolded(cfg) -> int:
    """Multiply-adds per point of the unfolded field (the backward's
    forward): every linear of ops/film_mlp_grad.py::mlp_layers."""
    h, g = cfg.hidden_dim, cfg.grid_channels
    return (3 * h + (cfg.trunk_layers - 1) * h * h
            + (3 + g + h) * h + (cfg.color_layers - 1) * h * h
            + h
            + cfg.label_hidden_layers * h * h + h * cfg.n_labels
            + h * cfg.rgb_dim)


def phase_backward(dev) -> dict:
    """The backward kernels against their plain version per output group,
    by the criterion ops/film_mlp_grad.py::bwd_agreement states (the one
    the card tests use), at the G shape and a ragged one. Returns the G
    shape's times and bound, the worst errors over both shapes, and each
    shape's numbers under "shapes"."""
    from fenerf_tpu_torch.nn import fields
    from fenerf_tpu_torch.ops import film_mlp_grad as gops

    cfg, params, gen = _flagship_params(dev, seed=3)
    params = fields.with_grid_table(params, cfg, torch.bfloat16)
    pack = gops.pack_bwd(params, cfg)
    shapes = []
    for b, n in ((6, 32 * 32 * 24), (2, 1000)):
        pts = (torch.rand(b, n, 3, generator=gen, device=dev) - 0.5) * 0.24
        dirs = torch.nn.functional.normalize(
            torch.randn(b, n, 3, generator=gen, device=dev), dim=-1)
        zg = torch.randn(b, cfg.z_geo_dim, generator=gen, device=dev)
        za = torch.randn(b, cfg.z_app_dim, generator=gen, device=dev)
        fg, fa = fields.field_film(params, cfg, zg, za)
        warped = pts * (2.0 / cfg.box_side)
        gf = fields._grid_feats(params, warped, torch.bfloat16)
        g_out = torch.randn(b, n, cfg.output_dim, generator=gen, device=dev)
        args = (pack, warped, dirs, gf, fg, fa, g_out)
        out = gops.film_mlp_bwd(*args)
        ref = gops.film_mlp_bwd_reference(*args)
        torch.cuda.synchronize()
        groups = gops.bwd_agreement(out, ref)
        worst_rel = max(groups, key=lambda r: r[1])
        worst_cos = min(groups, key=lambda r: r[2])
        rows = b * n
        ms = time_ms(lambda: gops.film_mlp_bwd(*args), iters=5)
        plain_ms = time_ms(lambda: gops.film_mlp_bwd_reference(*args),
                           iters=2, warmup=1)
        flops = 6 * _macs_per_point_unfolded(cfg) * rows
        nbytes = (rows * (4 * 3 * 2 + 2 * cfg.grid_channels
                          + 4 * cfg.output_dim               # inputs
                          + 4 * 3 * 2 + 4 * cfg.grid_channels)  # outputs
                  + pack.weights.numel() * 2
                  + 4 * sum(w.numel() + bb.numel() for w, bb in out[0]))
        bound, by = bound_ms(flops, nbytes)
        log(f"[backward] B={b} N={n} rows={rows} worst max|diff|/max|plain| "
            f"{worst_rel[1]:.3e} ({worst_rel[0]}), worst cosine "
            f"{worst_cos[2]:.7f} ({worst_cos[0]}) (limits {gops.BWD_TOL}, "
            f"per-point groups {gops.BWD_TOL_PER_POINT}, cos > "
            f"{gops.BWD_COS}); kernel {ms:.3f} ms plain {plain_ms:.3f} ms, "
            f"{rows / ms / 1e3:.2f} Mpts/s, {flops / ms / 1e9:.1f} TFLOP/s, "
            f"bound {bound:.3f} ms ({by})")
        log("[backward] groups " + " ".join(
            f"{nm}:{rel:.2e}/{cos:.6f}" for nm, rel, cos, _ in groups))
        bad = [r for r in groups if not r[3]]
        if bad:
            raise AssertionError(f"backward kernel disagrees: {bad}")
        shapes.append({
            "B": b, "N": n, "max_abs_err": max(
                (x - y).abs().max().item() for xs, ys in zip(out[0], ref[0])
                for x, y in zip(xs, ys)),
            "max_rel_err": worst_rel[1], "min_cos": worst_cos[2], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by})
        del out, ref
    return {**shapes[0], **{k: max(s[k] for s in shapes) for k in
                            ("max_abs_err", "max_rel_err")},
            "min_cos": min(s["min_cos"] for s in shapes), "library_ms": None,
            "shapes": shapes}


def _synthetic_reals(gen, b, size, dev):
    """Smooth random images in [-1, 1] (bilinear upsampling of 4x4 noise)
    and one-hot 18-class label maps scaled to [-1, 1]."""
    up = lambda t: torch.nn.functional.interpolate(
        t, size=(size, size), mode="bilinear", align_corners=False)
    imgs = up(torch.rand(b, 3, 4, 4, generator=gen, device=dev) * 2 - 1)
    lab = up(torch.rand(b, 18, 8, 8, generator=gen, device=dev)).argmax(1)
    labels = torch.nn.functional.one_hot(lab, 18).permute(0, 3, 1, 2)
    return imgs.clamp(-1, 1), labels.float() * 2 - 1


def phase_train(dev):
    """TRAIN_STEPS steps of the flagship's stage 0 through the kernels.
    Returns the launches of each kernel and the state after the steps."""
    from fenerf_tpu_torch.ops import film_mlp, film_mlp_grad
    from fenerf_tpu_torch.train import loop
    from fenerf_tpu_torch.train.curriculum import CURRICULA

    cur = CURRICULA[TEXTURE]
    meta = cur.at_step(0)
    state = loop.init_train_state(meta, seed=0, device="cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    as_t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # --- the main path: counts from zero ---
    film_mlp.film_mlp.launches = 0
    film_mlp.film_mlp_reference.calls = 0
    film_mlp_grad.film_mlp_bwd.launches = 0
    film_mlp_grad.film_mlp_bwd_reference.calls = 0

    times = []
    for step in range(TRAIN_STEPS):
        imgs, labels = _synthetic_reals(gen, meta.batch_size, meta.img_size,
                                        dev)
        scal = loop.StepScalars(alpha=as_t(cur.alpha(step)),
                                noise_std=as_t(meta.nerf_noise(step)),
                                topk_frac=as_t(meta.topk_fraction(step)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = loop.train_step(state, imgs, labels, scal, meta,
                                   generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses = {k: float(m[k]) for k in ("d_img_loss", "d_seg_loss",
                                           "g_loss", "fake_opacity")}
        log(f"[train] step {step}: " + " ".join(
            f"{k} {v:.5f}" for k, v in losses.items())
            + f" ({times[-1] * 1e3:.1f} ms)")
        if not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"non-finite loss at step {step}")
    counts = {"film_mlp": film_mlp.film_mlp.launches,
              "film_mlp_bwd": film_mlp_grad.film_mlp_bwd.launches}
    plain = (film_mlp.film_mlp_reference.calls
             + film_mlp_grad.film_mlp_bwd_reference.calls)
    ms = statistics.median(times[1:]) * 1e3
    log(f"[train] {TEXTURE} stage 0 (bs {meta.batch_size}, split "
        f"{meta.batch_split}, {meta.img_size}^2, {meta.num_steps}+"
        f"{meta.num_steps} steps): {ms:.1f} ms/step (median of steps 2-"
        f"{TRAIN_STEPS}; range {min(times[1:]) * 1e3:.1f}-"
        f"{max(times[1:]) * 1e3:.1f}), {meta.batch_size / ms * 1e3:.2f} "
        f"images/s; launches {counts}, plain-version calls {plain}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if min(counts.values()) <= 0 or plain != 0:
        raise AssertionError("training did not run through the kernels "
                             "alone")
    return counts, state


def _grad_compare(x, y):
    """Worst per-group cosine and relative norm difference (against y) of
    two gradient leaf lists, skipping groups whose two norms are both below
    1e-8; and the number of groups compared."""
    worst_cos, worst_norm, n_cmp = 1.0, 0.0, 0
    for a, b in zip(x, y):
        a, b = a.double().flatten(), b.double().flatten()
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            return float("nan"), float("nan"), n_cmp
        na, nb = a.norm().item(), b.norm().item()
        if na < 1e-8 and nb < 1e-8:
            continue
        n_cmp += 1
        worst_cos = min(worst_cos, (a @ b).item() / max(na * nb, 1e-30))
        worst_norm = max(worst_norm, abs(na - nb) / max(nb, 1e-12))
    return worst_cos, worst_norm, n_cmp


def _g_grads(state, meta, backend, compute_dtype, loss_fn):
    """G's parameter gradients (texture grid folded from the bf16 table's
    cotangent) of loss_fn(params, fcfg, rcfg) through one route."""
    import dataclasses

    from fenerf_tpu_torch.compat.jax_bridge import tree_leaves
    from fenerf_tpu_torch.core.grid_sample import (build_zexp_table,
                                                   zexp_table_adjoint)
    from fenerf_tpu_torch.nn import fields
    from fenerf_tpu_torch.train import loop

    with torch.no_grad():
        table = build_zexp_table(state.g_params["grid"], torch.bfloat16)
    rcfg = dataclasses.replace(meta.render_config(), backend=backend,
                               compute_dtype=compute_dtype)
    rp = loop._leaf_copy({**state.g_params, fields.GRID_TABLE_KEY: table})
    loss = loss_fn(rp, meta.field_config(), rcfg)
    g = loop._grads(loss, rp)
    g["grid"] = g["grid"] + zexp_table_adjoint(
        g.pop(fields.GRID_TABLE_KEY), tuple(state.g_params["grid"].shape))
    return loss.item(), tree_leaves(g)


def phase_grad(dev, meta, trained):
    """G's gradient through the kernels against the torch route at bf16.

    Held to the criterion: the field's vector-Jacobian product at the G
    shape (one microbatch, B=6, N=32^2 x 24): apply_field through
    'kernel_train' (FilmMlpTrainable: the forward and backward kernels)
    and through the torch route, the same points, latents and output
    cotangent, gradients of every G parameter (mapping networks, field
    layers, the texture grid through the table), at the initial state and
    at the state after phase 6. Both round every product
    operand to bf16; they differ in the heads (bf16 operands in the
    kernels, f32 on the torch route) and in summation order.

    Printed as context, not held: the same comparison through a whole G
    microbatch render and loss with the same draws, at the initial state
    (three draw seeds at the step-0 sigma noise, one with none) and at the
    state after phase 6. A render's gradient is not a smooth function of
    such roundings where a sample's density sits at the ReLU's kink, so
    the torch route at f32 against bf16 is printed beside it."""
    from fenerf_tpu_torch.nn import fields
    from fenerf_tpu_torch.train import loop

    initial = loop.init_train_state(meta, seed=0, device=dev)
    fcfg = meta.field_config()
    bs = meta.batch_size // meta.batch_split
    n = meta.img_size ** 2 * meta.num_steps
    gen = torch.Generator(device=dev).manual_seed(7)
    pts = (torch.rand(bs, n, 3, generator=gen, device=dev) - 0.5) * 0.24
    dirs = torch.nn.functional.normalize(
        torch.randn(bs, n, 3, generator=gen, device=dev), dim=-1)
    zg = torch.randn(bs, fcfg.z_geo_dim, generator=gen, device=dev)
    za = torch.randn(bs, fcfg.z_app_dim, generator=gen, device=dev)
    g_out = torch.randn(bs, n, fcfg.output_dim, generator=gen, device=dev)

    def field_vjp(p, fcfg, rcfg):
        fg, fa = fields.field_film(p, fcfg, zg, za)
        out = fields.apply_field(p, fcfg, pts, dirs, fg, fa,
                                 compute_dtype=torch.bfloat16,
                                 backend=rcfg.backend)
        return (out * g_out).sum()

    state_after, steps_after = trained
    for label, state in (("initial", initial),
                         (f"after {steps_after} steps", state_after)):
        fk = _g_grads(state, meta, "kernel_train", "bfloat16", field_vjp)
        ft = _g_grads(state, meta, "torch", "bfloat16", field_vjp)
        cos, dn, n_cmp = _grad_compare(fk[1], ft[1])
        log(f"[grad] field VJP at B={bs} N={n}, {label}: kernel_train vs "
            f"torch bf16 over {n_cmp} parameter groups: worst cosine "
            f"{cos:.7f} (> {GRAD_COS}), worst norm difference {dn:.5f} "
            f"(< {GRAD_NORM})")
        if not (cos > GRAD_COS and dn < GRAD_NORM):
            raise AssertionError("kernel-route field gradient disagrees "
                                 f"with the torch route ({label})")
        del fk, ft

    as_t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    settings = [(f"initial, draws {seed}, noise {meta.nerf_noise(0)}",
                 initial, seed, meta.nerf_noise(0)) for seed in (5, 6, 7)]
    settings += [("initial, draws 5, noise 0", initial, 5, 0.0),
                  (f"after {steps_after} steps, draws 5, noise "
                   f"{meta.nerf_noise(steps_after)}", state_after, 5,
                   meta.nerf_noise(steps_after))]
    for label, state, seed, noise in settings:
        scal = loop.StepScalars(as_t(1.0), as_t(noise), as_t(1.0))
        draws = loop.make_step_draws(
            torch.Generator(device=dev).manual_seed(seed), meta,
            meta.batch_size, scal.noise_std, dev)
        z_g, z_a = (z[:bs] for z in draws.z_g)

        def render_loss(p, fcfg, rcfg):
            return loop._g_loss(p, state.d_img_params, state.d_seg_params,
                                fcfg, rcfg, meta, z_g, z_a, scal, 1,
                                draws.g_renders[0])[0]

        kern, bf, f32 = (_g_grads(state, meta, backend, cd, render_loss)
                         for backend, cd in (("kernel_train", "bfloat16"),
                                             ("torch", "bfloat16"),
                                             ("torch", "float32")))
        cos, dn, n_cmp = _grad_compare(kern[1], bf[1])
        ccos, cdn, _ = _grad_compare(f32[1], bf[1])
        log(f"[grad] render, {label}: G loss kernel {kern[0]:.6f}, torch "
            f"bf16 {bf[0]:.6f}, f32 {f32[0]:.6f}; kernel vs torch bf16 over "
            f"{n_cmp} groups: worst cosine {cos:.6f}, worst norm difference "
            f"{dn:.4f}; torch f32 vs torch bf16: worst cosine {ccos:.6f}, "
            f"worst norm difference {cdn:.4f}")
        if not all(math.isfinite(v) for v in (kern[0], bf[0], f32[0], cos,
                                              ccos)):
            raise AssertionError(f"non-finite G loss or gradient ({label})")
        del kern, bf, f32


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    from fenerf_tpu_torch.train.curriculum import CURRICULA

    t_all = time.perf_counter()
    phase_card()
    kern = phase_kernel(dev)
    with tempfile.TemporaryDirectory() as tmp:
        serve_launches = phase_serve(dev, tmp)
    phase_render(dev)
    bwd = phase_backward(dev)
    train_launches, trained = phase_train(dev)
    phase_grad(dev, CURRICULA[TEXTURE].at_step(0), (trained, TRAIN_STEPS))
    log(f"[done] all phases in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [
        {"name": "film_mlp", "route": "cuda",
         "source": "fenerf_tpu_torch/ops/csrc/film_mlp.cu",
         "replaces": "fenerf_tpu/ops/film_mlp.py:128",
         "launches": serve_launches + train_launches["film_mlp"],
         "launches_serve": serve_launches,
         "launches_train": train_launches["film_mlp"], **kern},
        {"name": "film_mlp_bwd", "route": "cuda",
         "source": "fenerf_tpu_torch/ops/csrc/film_mlp_bwd.cu",
         "replaces": "fenerf_tpu/ops/film_mlp_grad.py:85",
         "launches": train_launches["film_mlp_bwd"], **bwd}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
