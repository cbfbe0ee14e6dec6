"""3D shape extraction CLI on the port: sigma volume on a voxel lattice ->
.mrc (and, with --export_ply, a mesh). Counterpart of
fenerf_tpu/apps/extract_shapes.py, both families.

Reference: extract_double_semantic_shapes.py — 256^3 lattice over a 0.3
cube, field evaluated with locked view direction (0, 0, -1), psi 0.5
truncation, sigma channel written as an .mrc volume (utils/mrc.py). Also
consumes inversion checkpoints (apps/invert.py's freq / phase .npz) like the
reference's sample_generator_wth_frequencies_phase_shifts path (:68-86).

The lattice goes through the field's torch route in f32 (TF32 off), as the
JAX package's through XLA: eval_volume passes no backend. The latent-grid
family's volume comes straight from z (eval_volume_grid: its plane once,
no W truncation).

Usage:
  python -m fenerf_tpu_torch.apps.extract_shapes --ckpt out/generator.npz \
      --seeds 0 1 --output_dir shapes [--export_ply] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True)
    p.add_argument("--seeds", nargs="+", type=int, default=[0])
    p.add_argument("--output_dir", default="shapes")
    p.add_argument("--voxel_resolution", type=int, default=256)
    p.add_argument("--cube_size", type=float, default=0.3)
    p.add_argument("--psi", type=float, default=0.5)
    p.add_argument("--no_ema", dest="use_ema", action="store_false")
    p.add_argument("--inversion_ckpt", default=None,
                   help=".npz of inverted film tensors (apps/invert.py)")
    p.add_argument("--chunk", type=int, default=262144)
    p.add_argument("--export_ply", action="store_true",
                   help="also mesh the sigma volume and write a .ply surface")
    p.add_argument("--mesher", choices=("cubes", "tet"), default="cubes",
                   help="'cubes' = classic marching cubes (the reference "
                        "meshes with skimage marching cubes, "
                        "extract_shapes.py:1-8); 'tet' = marching tetrahedra")
    p.add_argument("--shard_rays", action="store_true",
                   help="split the lattice into slabs over every visible "
                        "GPU (models/generator.py::eval_volume_sharded)")
    p.add_argument("--iso_level", type=float, default=10.0,
                   help="sigma iso level for the mesh")
    p.add_argument("--device", default="cuda",
                   help="torch device (raises if CUDA is requested and "
                        "absent)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from fenerf_tpu_torch.apps.common import load_generator, shard_devices
    from fenerf_tpu_torch.models import generator as gen
    from fenerf_tpu_torch.nn import fields
    from fenerf_tpu_torch.utils.mrc import write_mrc
    from fenerf_tpu_torch.utils.precision import exact_matmuls

    dev = torch.device(args.device)
    params, ema, _, fcfg, config = load_generator(args.ckpt, device=dev)
    if args.use_ema:
        params = ema
    is_grid = config["family"] == "grid"
    if is_grid and args.inversion_ckpt:
        raise SystemExit("--inversion_ckpt holds film-family W offsets; "
                         f"{args.ckpt} is a latent-grid checkpoint")
    os.makedirs(args.output_dir, exist_ok=True)
    res = args.voxel_resolution
    pts = gen.voxel_points(res, args.cube_size, device=dev)
    devices = shard_devices(dev) if args.shard_rays else None
    if devices:
        print(f"[shard_rays] {len(devices)} device(s)", flush=True)
    timings = []

    def extract(film_geo, film_app, name, z=None):
        t0 = time.perf_counter()
        # the lattice is evaluated in f32: no TF32 in its products
        # (ROADMAP F4), the process's flag restored after
        with exact_matmuls():
            if is_grid:
                out = gen.eval_volume_grid(params, fcfg, z, pts,
                                           chunk=args.chunk, devices=devices)
            else:
                out = gen.eval_volume(params, fcfg, film_geo, film_app, pts,
                                      chunk=args.chunk, devices=devices)
        sigma = (out[:, -1].float().cpu().numpy().reshape(res, res, res))
        t_volume = time.perf_counter() - t0
        path = os.path.join(args.output_dir, f"{name}.mrc")
        write_mrc(path, sigma, voxel_size=args.cube_size / res)
        print(f"wrote {path} (sigma in [{sigma.min():.2f}, "
              f"{sigma.max():.2f}]) in {t_volume:.2f} s")
        t_mesh = None
        if args.export_ply:
            from fenerf_tpu_torch.utils.marching import (marching_cubes,
                                                         marching_tetrahedra,
                                                         write_ply)

            t0 = time.perf_counter()
            mesher = (marching_cubes if args.mesher == "cubes"
                      else marching_tetrahedra)
            vox = args.cube_size / res
            verts, faces = mesher(
                sigma, level=args.iso_level, spacing=(vox, vox, vox),
                origin=(-args.cube_size / 2,) * 3)
            ply = os.path.join(args.output_dir, f"{name}.ply")
            write_ply(ply, verts, faces)
            t_mesh = time.perf_counter() - t0
            print(f"wrote {ply} ({len(verts)} verts, {len(faces)} faces) "
                  f"in {t_mesh:.2f} s")
        timings.append({"name": name, "volume_s": t_volume,
                        "mesh_s": t_mesh})

    if args.inversion_ckpt:
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        with np.load(args.inversion_ckpt) as data:
            film_geo = (t(data["freq_geo"]), t(data["phase_geo"]))
            film_app = (t(data["freq_app"]), t(data["phase_app"]))
        name = os.path.splitext(os.path.basename(args.inversion_ckpt))[0]
        extract(film_geo, film_app, f"shape_{name}")
        return timings

    if is_grid:
        for seed in args.seeds:
            g = torch.Generator(device=dev).manual_seed(seed)
            zg = torch.randn((1, fcfg.z_geo_dim), generator=g, device=dev)
            extract(None, None, f"shape_seed{seed}", z=zg)
        return timings

    with torch.no_grad():
        avg = fields.avg_film(params, fcfg,
                              torch.Generator(device=dev).manual_seed(42))
        films = []
        for seed in args.seeds:
            g = torch.Generator(device=dev).manual_seed(seed)
            zg = torch.randn((1, fcfg.z_geo_dim), generator=g, device=dev)
            za = torch.randn((1, fcfg.z_app_dim), generator=g, device=dev)
            fg, fa = fields.field_film(params, fcfg, zg, za)
            films.append((seed, fields.truncate_film(fg, avg[0], args.psi),
                          fields.truncate_film(fa, avg[1], args.psi)))
    for seed, fg, fa in films:
        extract(fg, fa, f"shape_seed{seed}")
    return timings


if __name__ == "__main__":
    main()
