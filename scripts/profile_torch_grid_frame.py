"""Where the time of one latent-grid video frame goes, on the port (one
NVIDIA GPU).

  python scripts/profile_torch_grid_frame.py [--frames 5] [--out table.txt]

Builds SPATIALSIRENGRID at its published widths from random weights (seed
3, the sigma head's bias +20: an opaque volume, as chip_smoke.py does),
then renders render_video's first frame at the CLI's defaults (128^2,
24 + 24 steps, ray_chunk 4096, bf16 FiLM operands) through
apps/render_video.py::frame_renderer:
  * the latent plane 8 times from the same z, the largest |difference|
    from the first, with the StyleGAN convolutions on cuDNN's
    deterministic algorithms (utils/precision.py::exact_convs, as
    ops/upfirdn2d.py runs them) and on cuDNN's default choice (TF32 off in both);
  * ms per frame on the host clock (each frame ends in a device sync),
    min / median / max over --frames, and the peak device memory;
  * one frame under torch.profiler: device time by kernel name, grouped
    into products (GEMM kernels), elementwise kernels and the rest, with
    their launches, and the device's busy share of a frame (the traced
    frame's kernel time over the median frame's host time; the traced
    window itself holds the profiler's start-up).
The ray kernels follow FENERF_RAY_KERNELS, as in the CLI (default off).
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

GRID = "SPATIALSIRENGRID"
SIGMA_BIAS = 20.0
GROUPS = (("products", ("gemm",)), ("elementwise", ("elementwise",)))


def group_of(kernel: str) -> str:
    name = kernel.lower()
    for group, marks in GROUPS:
        if any(m in name for m in marks):
            return group
    return "other"


def plane_spread(plane, calls: int = 8) -> float:
    """Largest max |plane() - the first plane()| over `calls` calls."""
    first = plane()
    return max((plane() - first).abs().max().item()
               for _ in range(calls - 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--out", help="write the full per-kernel table here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_grid_frame: needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from fenerf_tpu_torch.apps import render_video
    from fenerf_tpu_torch.apps.common import (best_backend,
                                              camera_trajectory, route_line)
    from fenerf_tpu_torch.nn import latent_grid_field as lgf
    from fenerf_tpu_torch.ops import upfirdn2d
    from fenerf_tpu_torch.ops.probes import card, require_cuda

    dev = require_cuda("profile_torch_grid_frame")
    torch.backends.cudnn.allow_tf32 = False
    name = card()
    print(name)
    cfg = lgf.get_grid_config(GRID)
    params = lgf.init_grid_field(torch.Generator(device=dev).manual_seed(3),
                                 cfg, device=dev)
    params["sigma_head"]["b"] = params["sigma_head"]["b"] + SIGMA_BIAS
    vargs = render_video.parse_args(["--ckpt", "-"])
    rcfg = render_video.render_config(vargs, cfg, best_backend(cfg, dev))
    print(f"[grid frame] {route_line(cfg, rcfg, dev)}")
    films_for_seed, render_frame = render_video.frame_renderer(
        params, cfg, rcfg, vargs.psi, dev)
    _, pitch, yaw, fov = camera_trajectory(vargs.trajectory,
                                           vargs.num_frames, 12.0)[0]
    draws = render_video.frame_draws(rcfg, dev)

    with torch.no_grad():
        films = films_for_seed(0)
        plane = lambda: lgf.compute_plane(params, cfg, films[0][0])
        exact = plane_spread(plane)
        defaults = lambda: torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=False,
            allow_tf32=False)
        kept = upfirdn2d.exact_convs
        upfirdn2d.exact_convs = defaults
        try:
            default = plane_spread(plane)
        finally:
            upfirdn2d.exact_convs = kept
        print(f"[grid frame] latent plane over 8 calls, max |diff| from "
              f"the first: deterministic algorithms {exact:.3e}, cuDNN's "
              f"default choice {default:.3e}")

        def frame():
            return render_frame(*films, (pitch, yaw, fov), draws)["pixels"]

        frame()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(args.frames):
            t0 = time.perf_counter()
            frame()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        median = statistics.median(times)
        print(f"[grid frame] {name}: {args.frames} frames, min "
              f"{min(times):.2f} median {median:.2f} max "
              f"{max(times):.2f} ms per frame; peak device memory "
              f"{peak:.2f} GiB")

        from torch.profiler import ProfilerActivity, profile

        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            frame()
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    dev_attr = ("self_device_time_total"
                if hasattr(events[0], "self_device_time_total")
                else "self_cuda_time_total")
    rows = [(e.key, getattr(e, dev_attr), e.count) for e in events
            if getattr(e, dev_attr) > 0 and e.device_type.name == "CUDA"]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    groups = {}
    for key, us, n in rows:
        g = groups.setdefault(group_of(key), [0.0, 0])
        g[0] += us
        g[1] += n
    lines = [f"{name}; one traced frame, wall {wall_us / 1e3:.1f} ms, "
             f"device kernel time {total / 1e3:.1f} ms, busy share of a "
             f"frame {total / 1e3 / median:.3f}; by group: " + ", ".join(
                 f"{g} {us / 1e3:.1f} ms ({us / max(total, 1):.1%}, "
                 f"{n} launches)" for g, (us, n) in sorted(
                     groups.items(), key=lambda kv: -kv[1][0]))]
    for key, us, n in rows:
        lines.append(f"{us / 1e3:10.3f} ms {us / max(total, 1):6.1%} "
                     f"x{n:<5d} {key[:110]}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    print("\n".join(lines[:20]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
