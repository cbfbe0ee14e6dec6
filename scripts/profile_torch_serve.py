"""Where the time of one served render goes, on the port (one NVIDIA GPU).

  python scripts/profile_torch_serve.py [--iters 10] [--out table.txt]

Builds the flagship renderer at the serve defaults (128^2, 24x2 steps,
ray_chunk 4096, bf16, fused CUDA field kernel) from random full-width
weights, then:
  * times --iters requests on the host clock (each ends in a device sync):
    min / median / max ms per request and rays/s;
  * traces 3 requests with torch.profiler and prints device time by kernel
    name, the fused field kernel's share, and the device's busy share of
    the traced window (kernel time / wall time; overlapping kernels would
    count twice, the port runs one stream).
--out writes the full table to a file. The ray kernels follow
FENERF_RAY_KERNELS as in the server (default off); run it once with each
setting to compare.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FLAGSHIP = "TextureEmbeddingPiGAN256SEMANTICDISENTANGLE_DIM_96"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", help="write the full per-kernel table here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_serve: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from fenerf_tpu_torch.apps.common import save_generator
    from fenerf_tpu_torch.apps.serve import build_renderer
    from fenerf_tpu_torch.nn import fields

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    cfg = fields.get_config(FLAGSHIP)
    params = fields.init_field(torch.Generator(device=dev).manual_seed(1),
                               cfg, device=dev)
    params["sigma_head"]["b"] = params["sigma_head"]["b"] + 20.0
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "generator.npz")
        save_generator(ckpt, params, params, params, FLAGSHIP, step=0)
        del params
        render_np, meta = build_renderer(
            ckpt, 128, 24, 2, 12.0, "seg_padding_background", "black", 4096,
            True, device="cuda")
    print(f"ray route: {meta['ray_route']} ({meta['ray_route_why']})")

    def request():
        return render_np(0, 0.1, 0.0, 0.7)

    for _ in range(2):
        request()
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    rays = 128 * 128
    med = statistics.median(times)
    print(f"[time] {card}: {args.iters} batch-1 requests: "
          f"min {min(times):.2f} median {med:.2f} max {max(times):.2f} ms, "
          f"{rays / med * 1e3:.0f} rays/s at the median")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for _ in range(3):
            request()
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
    lines = [f"{card}; 3 traced requests, wall {wall_us / 1e3:.1f} ms, "
             f"device kernel time {total / 1e3:.1f} ms, "
             f"busy share {total / wall_us:.3f}"]
    for key, us, n in rows:
        lines.append(f"{us / 1e3:10.3f} ms {us / max(total, 1):6.1%} "
                     f"x{n:<5d} {key[:110]}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    print("\n".join(lines[:25]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
