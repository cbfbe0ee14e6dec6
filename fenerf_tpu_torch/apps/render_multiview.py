"""Multiview portrait renderer CLI on the port (counterpart of
fenerf_tpu/apps/render_multiview.py, film family).

Reference: render_multiview_images_double_semantic.py — loads generator +
EMA, renders each seed at 5 yaw angles (h_mean +- {0, 0.25, 0.5}) with psi
truncation, saves an RGB sheet and a palette-coloured segmentation sheet per
seed. On the card the field runs in the fused kernel (ops/film_mlp.py) and,
with FENERF_RAY_KERNELS=auto, the hierarchical machinery in the per-ray
kernels (ops/ray_finalize.py).

Usage:
  python -m fenerf_tpu_torch.apps.render_multiview --ckpt out/generator.npz \
      --seeds 0 1 2 3 --output_dir imgs --image_size 256 [--device cuda]
"""
from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np

YAW_OFFSETS = (-0.5, -0.25, 0.0, 0.25, 0.5)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True)
    p.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2])
    p.add_argument("--output_dir", default="imgs")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--num_steps", type=int, default=24)
    p.add_argument("--ray_step_multiplier", type=int, default=2)
    p.add_argument("--psi", type=float, default=0.7)
    p.add_argument("--no_ema", dest="use_ema", action="store_false")
    p.add_argument("--ray_chunk", type=int, default=4096)
    p.add_argument("--fov", type=float, default=12.0)
    p.add_argument("--fill_color", default="black",
                   choices=["black", "white", "grey", "light_grey"])
    p.add_argument("--fill_mode", default="seg_padding_background")
    p.add_argument("--shard_rays", action="store_true",
                   help="not ported yet (ROADMAP A6)")
    p.add_argument("--z_file", default=None,
                   help="npz with z_geo (S, d) [and z_app]: --seeds index "
                        "rows instead of seeding the RNG (render specific "
                        "latents, e.g. inverted ones)")
    p.add_argument("--deterministic", action="store_true",
                   help="hierarchical sampling + ray jitter off, f32 "
                        "compute: reproducible parity/debug mode")
    p.add_argument("--hd", action="store_true",
                   help="not ported yet (ROADMAP A6)")
    p.add_argument("--device", default="cuda",
                   help="torch device (raises if CUDA is requested and "
                        "absent)")
    args = p.parse_args(argv)
    if args.hd:
        raise NotImplementedError(
            "--hd (the neural-renderer upsampler heads) is not ported yet: "
            "ROADMAP A6, nn/neural_renderer.py and render_hd")
    if args.shard_rays:
        raise NotImplementedError(
            "--shard_rays (the rays of an image over several GPUs) is not "
            "ported yet: ROADMAP A6, the multi-GPU sharded renders")

    import torch

    from fenerf_tpu_torch.apps.common import best_backend, load_generator
    from fenerf_tpu_torch.models import generator as gen
    from fenerf_tpu_torch.nn import fields
    from fenerf_tpu_torch.ops import film_mlp
    from fenerf_tpu_torch.utils.image import (make_grid, mask2color,
                                              save_png, to_uint8)

    dev = torch.device(args.device)
    params, ema, _, fcfg, _config = load_generator(args.ckpt, device=dev)
    if args.use_ema:
        params = ema
    os.makedirs(args.output_dir, exist_ok=True)

    # reference default budget: num_steps x multiplier COARSE samples plus
    # an equal hierarchical fine pass (48 + 48 = 96 total at the defaults,
    # render_multiview_images_double_semantic.py:44 + generators.py:452-527)
    rcfg = gen.RenderConfig(
        img_size=args.image_size,
        num_steps=args.num_steps * args.ray_step_multiplier,
        hierarchical=not args.deterministic, perturb=not args.deterministic,
        fill_mode=args.fill_mode, fill_color=args.fill_color, fov=args.fov,
        ray_chunk=args.ray_chunk,
        compute_dtype="float32" if args.deterministic else "bfloat16",
        backend=best_backend(fcfg, dev))
    route, why = gen.ray_route(rcfg, dev)
    print(f"[multiview] field backend {rcfg.backend}, ray route {route} "
          f"({why})")
    # the texture table (and the kernel's operands) once, not per view
    table_dtype = (torch.bfloat16 if rcfg.backend != "torch"
                   or rcfg.compute_dtype == "bfloat16" else None)
    params = fields.with_grid_table(params, fcfg, table_dtype)
    if rcfg.backend == "kernel":
        params = film_mlp.with_pack(params, fcfg)

    zfile = np.load(args.z_file) if args.z_file else None
    sheets = []
    with torch.no_grad():
        avg = fields.avg_film(params, fcfg,
                              torch.Generator(device=dev).manual_seed(42))
        for seed in args.seeds:
            if zfile is not None:
                t = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                              device=dev)
                z_geo = t(zfile["z_geo"][seed:seed + 1])
                za_src = zfile["z_app"] if "z_app" in zfile else \
                    zfile["z_geo"]
                z_app = t(za_src[seed:seed + 1])
            else:
                g = torch.Generator(device=dev).manual_seed(seed)
                z_geo = torch.randn((1, fcfg.z_geo_dim), generator=g,
                                    device=dev)
                z_app = torch.randn((1, fcfg.z_app_dim), generator=g,
                                    device=dev)
            t0 = time.perf_counter()
            film_geo, film_app = fields.field_film(params, fcfg, z_geo, z_app)
            film_geo = fields.truncate_film(film_geo, avg[0], args.psi)
            film_app = fields.truncate_film(film_app, avg[1], args.psi)
            segs, views = [], []
            for off in YAW_OFFSETS:
                camera = (math.pi * 0.5, math.pi * 0.5 + off, args.fov)
                out = gen.render(
                    params, fcfg, rcfg, film_geo, film_app, batch_size=1,
                    noise_std=0.0, camera=camera,
                    generator=torch.Generator(device=dev).manual_seed(0))
                pix = out["pixels"].float().cpu().numpy()
                views.append(pix[0])
                if fcfg.n_labels:
                    segs.append(mask2color(pix[:, :-3])[0])
            views = np.stack(views)
            grid = make_grid(
                to_uint8(views[:, -3:], normalize=True).transpose(0, 2, 3, 1),
                nrow=len(YAW_OFFSETS))
            save_png(os.path.join(args.output_dir, f"img_{seed}.png"), grid)
            if segs:
                save_png(os.path.join(args.output_dir, f"seg_{seed}.png"),
                         make_grid(np.stack(segs), nrow=len(YAW_OFFSETS)))
            ms = (time.perf_counter() - t0) * 1e3
            sheets.append((seed, views, ms))
            print(f"seed {seed}: wrote {len(YAW_OFFSETS)} views in "
                  f"{ms:.1f} ms")
    # [(seed, (5, C, H, W) pixels in [-1, 1], ms for the sheet)]
    return sheets


if __name__ == "__main__":
    main()
