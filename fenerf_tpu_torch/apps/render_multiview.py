"""Multiview portrait renderer CLI on the port (counterpart of
fenerf_tpu/apps/render_multiview.py, both families).

Reference: render_multiview_images_double_semantic.py — loads generator +
EMA, renders each seed at 5 yaw angles (h_mean +- {0, 0.25, 0.5}) with psi
truncation, saves an RGB sheet and a palette-coloured segmentation sheet per
seed. On the card the film family's field runs in the fused kernel
(ops/film_mlp.py) and, with FENERF_RAY_KERNELS=auto, both families'
hierarchical machinery in the per-ray kernels (ops/ray_finalize.py). The
latent-grid family renders RGB only (white background fill, no seg sheet)
from z, without W truncation. --hd renders an *HD variant's features at
image_size / the heads' upsampling and upsamples them with the
checkpoint's neural renderers (models/generator.py::render_hd). An EG3D
checkpoint (family "eg3d") renders each view at the model's neural
rendering size (--image_size is not read), super-resolved, and its depth,
conditioned on the front camera as EG3D's sampler conditions
(models/generator.py::render_eg3d): img_{seed}.png and depth_{seed}.png.

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
                   help="split each image's rows into strips over every "
                        "visible GPU (models/generator.py::"
                        "render_image_sharded); both families; image_size "
                        "must divide by the device count")
    p.add_argument("--z_file", default=None,
                   help="npz with z_geo (S, d) [and z_app]: --seeds index "
                        "rows instead of seeding the RNG (render specific "
                        "latents, e.g. inverted ones)")
    p.add_argument("--deterministic", action="store_true",
                   help="hierarchical sampling + ray jitter off, f32 "
                        "compute: reproducible parity/debug mode")
    p.add_argument("--hd", action="store_true",
                   help="HD path: volumetric features + the checkpoint's "
                        "stored neural-renderer upsampler heads "
                        "(StyleGenerator3d, generators.py:914-1018); "
                        "--image_size is the UPSAMPLED output size")
    p.add_argument("--device", default="cuda",
                   help="torch device (raises if CUDA is requested and "
                        "absent)")
    args = p.parse_args(argv)
    if args.shard_rays and args.hd:
        raise ValueError("--hd is a single-device path: drop --shard_rays")

    import torch

    from fenerf_tpu_torch.apps.common import (best_backend, load_generator,
                                              load_neural_renderers,
                                              route_line, shard_devices)
    from fenerf_tpu_torch.models import generator as gen
    from fenerf_tpu_torch.nn import fields
    from fenerf_tpu_torch.ops import film_mlp
    from fenerf_tpu_torch.utils.image import (make_grid, mask2color,
                                              save_png, to_uint8)

    dev = torch.device(args.device)
    params, ema, _, fcfg, config = load_generator(args.ckpt, device=dev)
    if args.use_ema:
        params = ema
    os.makedirs(args.output_dir, exist_ok=True)
    is_grid = config["family"] == "grid"
    if is_grid and args.fill_mode == "seg_padding_background":
        args.fill_mode = "eval_white_back"   # the grid family is RGB-only

    if config["family"] == "eg3d":
        return _eg3d_sheets(args, params, fcfg, dev)

    nrs = {}
    render_size = args.image_size
    if args.hd:
        if is_grid:
            raise ValueError("--hd is a film-family path")
        nrs = load_neural_renderers(args.ckpt, device=dev)
        if "nr_img" not in nrs:
            raise ValueError(f"{args.ckpt} stores no neural-renderer heads "
                             "(--hd needs an HD checkpoint)")
        nr_cfg = nrs["nr_img"][1]
        up = nr_cfg.img_size // nr_cfg.input_size
        if args.image_size % up:
            raise ValueError(f"--image_size {args.image_size} is not a "
                             f"multiple of the heads' upsampling {up}")
        render_size = args.image_size // up   # the feature resolution

    # reference default budget: num_steps x multiplier COARSE samples plus
    # an equal hierarchical fine pass (48 + 48 = 96 total at the defaults,
    # render_multiview_images_double_semantic.py:44 + generators.py:452-527)
    rcfg = gen.RenderConfig(
        img_size=render_size,
        num_steps=args.num_steps * args.ray_step_multiplier,
        hierarchical=not args.deterministic, perturb=not args.deterministic,
        fill_mode=None if args.hd else args.fill_mode,
        fill_color=args.fill_color, fov=args.fov,
        ray_chunk=args.ray_chunk,
        compute_dtype="float32" if args.deterministic else "bfloat16",
        backend=best_backend(fcfg, dev))
    print(f"[multiview] {route_line(fcfg, rcfg, dev)}")
    devices = (shard_devices(dev, rcfg.img_size) if args.shard_rays
               else None)
    if not is_grid:
        # the texture table (and the kernel's operands) once, not per view
        table_dtype = (torch.bfloat16 if rcfg.backend != "torch"
                       or rcfg.compute_dtype == "bfloat16" else None)
        params = fields.with_grid_table(params, fcfg, table_dtype)
        if rcfg.backend == "kernel":
            params = film_mlp.with_pack(params, fcfg)

    zfile = np.load(args.z_file) if args.z_file else None
    sheets = []
    with torch.no_grad():
        if not is_grid:
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
            if is_grid:
                # the latent-grid family: no W-space truncation (its film
                # is per point)
                def render_view(camera):
                    g = torch.Generator(device=dev).manual_seed(0)
                    return gen.render_grid_from_z(
                        params, fcfg, rcfg, z_geo, camera=camera,
                        generator=g, devices=devices)
            else:
                film_geo, film_app = fields.field_film(params, fcfg, z_geo,
                                                       z_app)
                film_geo = fields.truncate_film(film_geo, avg[0], args.psi)
                film_app = fields.truncate_film(film_app, avg[1], args.psi)

                def render_view(camera):
                    g = torch.Generator(device=dev).manual_seed(0)
                    if args.hd:
                        nr_seg = nrs.get("nr_seg", (None, None))
                        return gen.render_hd(
                            params, fcfg, rcfg, film_geo, film_app, 1,
                            *nrs["nr_img"], *nr_seg, camera=camera,
                            generator=g)
                    return gen.render(
                        params, fcfg, rcfg, film_geo, film_app, batch_size=1,
                        camera=camera, generator=g, devices=devices)
            segs, views = [], []
            for off in YAW_OFFSETS:
                out = render_view((math.pi * 0.5, math.pi * 0.5 + off,
                                   args.fov))
                pix = out["pixels"].float().cpu().numpy()
                views.append(pix[0])
                if ("nr_seg" in nrs) if args.hd else fcfg.n_labels:
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


def _eg3d_sheets(args, params, cfg, dev):
    """The EG3D family's sheets: per seed, the 5 views' super-resolved
    images and their depth (JET over the sample range), psi lerping w
    toward the checkpoint's w_avg."""
    import torch

    from fenerf_tpu_torch.core import rays
    from fenerf_tpu_torch.models import generator as gen
    from fenerf_tpu_torch.utils.image import (depth_to_jet, make_grid,
                                              save_png, to_uint8)

    rcfg = gen.eg3d_render_config(
        img_size=cfg.sr_in,
        num_steps=args.num_steps * args.ray_step_multiplier,
        ray_chunk=args.ray_chunk)
    front = torch.full((1, 1), math.pi / 2, device=dev)
    label = lambda yaw, pitch: rays.eg3d_label(
        rays.lookat_cam2world(yaw, pitch), rays.eg3d_intrinsics(1,
                                                                device=dev))
    c = label(front, front)
    sheets = []
    with torch.no_grad():
        for seed in args.seeds:
            g = torch.Generator(device=dev).manual_seed(seed)
            z = torch.randn((1, cfg.z_dim), generator=g, device=dev)
            t0 = time.perf_counter()
            images, depths = [], []
            for off in YAW_OFFSETS:
                out = gen.render_eg3d(
                    params, cfg, rcfg, z, c, camera=label(front + off, front),
                    psi=args.psi,
                    generator=torch.Generator(device=dev).manual_seed(0))
                images.append(out["image"][0].float().cpu().numpy())
                depths.append(depth_to_jet(
                    out["depth"][0].float().cpu().numpy(), rcfg.ray_start,
                    rcfg.ray_end))
            images = np.stack(images)
            save_png(os.path.join(args.output_dir, f"img_{seed}.png"),
                     make_grid(to_uint8(images, normalize=True)
                               .transpose(0, 2, 3, 1),
                               nrow=len(YAW_OFFSETS)))
            save_png(os.path.join(args.output_dir, f"depth_{seed}.png"),
                     make_grid(np.stack(depths), nrow=len(YAW_OFFSETS)))
            ms = (time.perf_counter() - t0) * 1e3
            sheets.append((seed, images, ms))
            print(f"seed {seed}: wrote {len(YAW_OFFSETS)} views in "
                  f"{ms:.1f} ms")
    return sheets


if __name__ == "__main__":
    main()
