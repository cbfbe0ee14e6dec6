"""Free-viewpoint video with disentangled latent interpolation on the port
(counterpart of fenerf_tpu/apps/render_video.py, both families).

Reference: render_video_interpolation_semantic.py: a camera trajectory
(front / orbit / rotation_horizontal / rotation_linear / non_rotation /
sphere / inverse_sphere / zoom) and a geo / app / both / non latent lerp
between seed s and s + 1 in truncated W space (film family) or in z
(latent-grid family); each frame is a triptych [rgb | seg | rgb-seg blend |
depth (jet)] (rgb and depth alone for the RGB-only grid family).

The port writes each video as an uncompressed AVI
(seed{s}_{trajectory}_{latent}.avi, utils/video.py) where the JAX package
writes mp4 through cv2: the same frames, another container. On the card
the film family's field runs in the fused kernel (ops/film_mlp.py) and,
with FENERF_RAY_KERNELS=auto, both families' hierarchical machinery in
the per-ray kernels (ops/ray_finalize.py); the grid field runs its torch
route.

Usage:
  python -m fenerf_tpu_torch.apps.render_video --ckpt out/generator.npz \
      --seeds 0 --trajectory front --latent_type geo [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from fenerf_tpu_torch.apps.common import TRAJECTORIES
from fenerf_tpu_torch.models import generator as gen


class Video(NamedTuple):
    seed: int
    path: str             # the .avi
    frames: np.ndarray    # (N, H, W', 3) uint8: the triptychs written
    pixels: np.ndarray    # (N, C, H, W) float32 renders in [-1, 1]
    ms_per_frame: float   # render + host copy, host clock, synchronized


def seed_latents(seed: int, cfg, device):
    """(z_geo, z_app), each (1, d), of a seed: one generator seeded `seed`
    on `device`, z_geo drawn first (the grid family reads z_geo alone)."""
    g = torch.Generator(device=device).manual_seed(seed)
    zg = torch.randn((1, cfg.z_geo_dim), generator=g, device=device)
    za = torch.randn((1, cfg.z_app_dim), generator=g, device=device)
    return zg, za


def frame_draws(rcfg: gen.RenderConfig, device) -> gen.RenderDraws:
    """The draws every frame renders with (one generator seeded 0): the
    same for every frame, as the JAX CLI renders every frame from one
    key."""
    return gen.draw_render(torch.Generator(device=device).manual_seed(0), 1,
                           rcfg, 0.0, None, device)


def render_config(args, fcfg, backend: str) -> gen.RenderConfig:
    """The CLI's render settings for `fcfg`'s family on `backend`. The
    grid family is RGB-only: the default seg fill becomes the white
    background there."""
    fill = args.fill_mode
    if gen.is_grid_config(fcfg) and fill == "eval_seg_padding_background":
        fill = "eval_white_back"
    return gen.RenderConfig(
        img_size=args.image_size, num_steps=args.num_steps,
        hierarchical=True, fill_mode=fill, fill_color=args.fill_color,
        ray_chunk=args.ray_chunk, compute_dtype="bfloat16", backend=backend)


def frame_renderer(params, fcfg, rcfg: gen.RenderConfig, psi: float,
                   device, devices=None):
    """(films_for_seed, render_frame) of `fcfg`'s family:
    films_for_seed(seed) -> (film_geo, film_app), the endpoints that
    interpolate_films lerps between; render_frame(film_geo, film_app,
    camera, draws) -> render_core's dict for one frame, its rows in strips
    over `devices` where given."""
    from fenerf_tpu_torch.nn import fields
    from fenerf_tpu_torch.ops import film_mlp

    if gen.is_grid_config(fcfg):
        # latents lerp in z (the grid field's film is per point: no W
        # truncation); both slots carry (z, z) so that interpolate_films'
        # (f, p) pairs serve unchanged, and 'app' has no code of its own:
        # it holds endpoint 1
        def films_for_seed(seed):
            zg, _ = seed_latents(seed, fcfg, device)
            return (zg, zg), (zg, zg)

        def render_frame(film_geo, _film_app, camera, draws):
            return gen.render_grid_from_z(params, fcfg, rcfg, film_geo[0],
                                          camera=camera, draws=draws,
                                          devices=devices)

        return films_for_seed, render_frame

    # the texture table and the kernel's operands once, not per frame
    params = fields.with_grid_table(params, fcfg, torch.bfloat16)
    if rcfg.backend == "kernel":
        params = film_mlp.with_pack(params, fcfg)
    with torch.no_grad():
        avg = fields.avg_film(params, fcfg,
                              torch.Generator(device=device).manual_seed(42))

    def films_for_seed(seed):
        zg, za = seed_latents(seed, fcfg, device)
        fg, fa = fields.field_film(params, fcfg, zg, za)
        return (fields.truncate_film(fg, avg[0], psi),
                fields.truncate_film(fa, avg[1], psi))

    def render_frame(film_geo, film_app, camera, draws):
        return gen.render(params, fcfg, rcfg, film_geo, film_app,
                          batch_size=1, camera=camera, draws=draws,
                          devices=devices)

    return films_for_seed, render_frame


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True)
    p.add_argument("--seeds", nargs="+", type=int, default=[0])
    p.add_argument("--output_dir", default="videos")
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--num_steps", type=int, default=24)
    p.add_argument("--num_frames", type=int, default=36)
    p.add_argument("--fps", type=int, default=12)
    p.add_argument("--psi", type=float, default=0.7)
    p.add_argument("--trajectory", default="front", choices=TRAJECTORIES)
    p.add_argument("--latent_type", default="geo",
                   choices=["geo", "app", "both", "non"])
    p.add_argument("--no_ema", dest="use_ema", action="store_false")
    p.add_argument("--save_frames", action="store_true")
    p.add_argument("--ray_chunk", type=int, default=4096)
    p.add_argument("--fill_color", default="black",
                   choices=["black", "white", "grey", "light_grey"])
    p.add_argument("--fill_mode", default="eval_seg_padding_background")
    p.add_argument("--shard_rays", action="store_true",
                   help="split each frame's rows into strips over every "
                        "visible GPU (models/generator.py::"
                        "render_image_sharded / render_grid_sharded); both "
                        "families; image_size must divide by the device "
                        "count")
    p.add_argument("--device", default="cuda",
                   help="torch device (raises if CUDA is requested and "
                        "absent)")
    return p.parse_args(argv)


def main(argv=None) -> list[Video]:
    args = parse_args(argv)

    from fenerf_tpu_torch.apps.common import (best_backend,
                                              camera_trajectory,
                                              interpolate_films,
                                              load_generator, route_line,
                                              shard_devices)
    from fenerf_tpu_torch.utils.image import (depth_to_jet, mask2color,
                                              save_png, to_uint8)
    from fenerf_tpu_torch.utils.video import write_avi

    dev = torch.device(args.device)
    params, ema, _, fcfg, config = load_generator(args.ckpt, device=dev)
    if args.use_ema:
        params = ema
    os.makedirs(args.output_dir, exist_ok=True)
    rcfg = render_config(args, fcfg, best_backend(fcfg, dev))
    print(f"[video] {config['family']} family, "
          f"{route_line(fcfg, rcfg, dev)}")
    devices = (shard_devices(dev, rcfg.img_size) if args.shard_rays
               else None)
    films_for_seed, render_frame = frame_renderer(params, fcfg, rcfg,
                                                  args.psi, dev, devices)

    traj = camera_trajectory(args.trajectory, args.num_frames,
                             base_fov=12.0)
    draws = frame_draws(rcfg, dev)
    videos = []
    for seed in args.seeds:
        with torch.no_grad():
            films1 = films_for_seed(seed)
            films2 = films_for_seed(seed + 1)
        frames, pixels = [], []
        t_render = 0.0
        for i, (t, pitch, yaw, fov) in enumerate(traj):
            fg = interpolate_films(films1[0], films2[0], t,
                                   args.latent_type, "geo")
            fa = interpolate_films(films1[1], films2[1], t,
                                   args.latent_type, "app")
            t0 = time.perf_counter()
            with torch.no_grad():
                out = render_frame(fg, fa, (pitch, yaw, fov), draws)
            pix = out["pixels"][0].float().cpu().numpy()
            depth = out["depth"][0].float().cpu().numpy()
            t_render += time.perf_counter() - t0
            rgb = to_uint8(pix[-3:], normalize=False).transpose(1, 2, 0)
            panels = [rgb]
            if fcfg.n_labels:
                panels.append(mask2color(pix[None, :-3])[0])
                panels.append((0.5 * rgb + 0.5 * panels[1]).astype(np.uint8))
            panels.append(depth_to_jet(depth))
            frame = np.concatenate(panels, axis=1)
            frames.append(frame)
            pixels.append(pix)
            if args.save_frames:
                save_png(os.path.join(
                    args.output_dir, f"seed{seed}_{args.trajectory}_"
                    f"{args.latent_type}_{i:04d}.png"), frame)
        path = os.path.join(
            args.output_dir,
            f"seed{seed}_{args.trajectory}_{args.latent_type}.avi")
        write_avi(path, frames, fps=args.fps)
        ms = t_render / len(traj) * 1e3
        print(f"wrote {path} ({len(frames)} frames, {ms:.1f} ms per frame)")
        videos.append(Video(seed, path, np.stack(frames), np.stack(pixels),
                            ms))
    return videos


if __name__ == "__main__":
    main()
