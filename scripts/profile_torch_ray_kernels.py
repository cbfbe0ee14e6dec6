"""The fused per-ray kernels' times on one NVIDIA GPU, the device's apart
from the host's: the port's counterpart of scripts/profile_ray_kernels.py.

  python scripts/profile_torch_ray_kernels.py [--iters 50] [--seed 0]
      [--out chiprun_out/profile_torch_ray_kernels.json]

At each of the main path's ray shapes (ops/probes.py::RAY_SHAPES, those of
chip_smoke.py phase 3: the serving block B=1 R=4096 48+48 without noise,
the training microbatch B=6 R=1024 24+24 with noise, a ragged B=3 R=1001
37+37 with noise), for ray_resample and ray_finalize
(ops/csrc/ray_finalize.cu) it prints:
  event_ms    CUDA events around --iters back-to-back wrapper calls (the
              timer of PERF.md's kernel table; it reads the host's dispatch
              rate where that is the slower side)
  device_ms   the kernel's own mean duration in torch.profiler's trace
  host_us     the wrapper's host time per call (checks, allocation, the
              ctypes launch), the device drained around the loop
  bound_ms    bytes or operations over the card's peak rate, and its share
              of device_ms
and, as the floor under them, an empty kernel's device time over the
resample kernel's grid (B*R/4 CTAs of 128 threads), measured the same way.
Also the kernels' max |kernel - plain| at that draw, so a wrong kernel is
never timed unnoticed. Writes all of it with the card's name and power
limit to --out. Needs CUDA.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fenerf_tpu_torch.ops import probes  # noqa: E402
from fenerf_tpu_torch.ops import ray_finalize as rf  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out",
                    default="chiprun_out/profile_torch_ray_kernels.json")
    args = ap.parse_args(argv)
    dev = probes.require_cuda("profile_torch_ray_kernels")
    card = probes.card()
    print(card, flush=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n = args.iters
    res = {}
    for label, b, r, s, noisy in probes.RAY_SHAPES:
        z, sigma, outputs = probes.ray_inputs(gen, dev, b, r, s)
        randn = lambda k: torch.randn(b, r, k, generator=gen, device=dev)
        nz_c, nz_f = (randn(s), randn(2 * s)) if noisy else (None, None)
        u = torch.rand(b, r, s, generator=gen, device=dev)
        fo, co = outputs(s), outputs(s)
        fz = rf.ray_resample(sigma, z, nz_c, u)
        err_z = (fz - rf.ray_resample_reference(sigma, z, nz_c, u)
                 ).abs().max().item()
        err_f = max((a - p).abs().max().item() for a, p in zip(
            rf.ray_finalize(fo, co, fz, z, nz_f),
            rf.ray_finalize_reference(fo, co, fz, z, nz_f)))
        bounds = probes.ray_bounds(b, r, s, noisy)
        empty = probes.empty_launcher((b * r + 3) // 4)
        floor = (probes.device_ms(empty, n, "empty_kernel")
                 if empty is not None else None)
        shape = {"B": b, "R": r, "S": s, "noise": noisy,
                 "empty_device_ms": floor}
        print(f"{label} B={b} R={r} S={s}+{s} noise={noisy}: max|kernel-"
              f"plain| fine z {err_z:.3e}, finalize {err_f:.3e}; empty "
              f"kernel over {(b * r + 3) // 4} CTAs: "
              + (f"{floor:.4f} ms device" if floor is not None
                 else "not in this tree"), flush=True)
        for (name, fn, kernel, err), (bound, by) in zip(
                (("ray_resample", lambda: rf.ray_resample(sigma, z, nz_c, u),
                  "ray_resample_kernel", err_z),
                 ("ray_finalize", lambda: rf.ray_finalize(fo, co, fz, z,
                                                          nz_f),
                  "ray_finalize_kernel", err_f)), bounds):
            rec = {"event_ms": probes.time_ms(fn, n),
                   "device_ms": probes.device_ms(fn, n, kernel),
                   "host_us": probes.host_us(fn, n),
                   "bound_ms": bound, "bound_by": by, "max_abs_err": err}
            rec["share_of_bound"] = bound / rec["device_ms"]
            shape[name] = rec
            print(f"  {name}: event {rec['event_ms']:.4f} ms, device "
                  f"{rec['device_ms']:.4f} ms, host {rec['host_us']:.1f} us "
                  f"per call, bound {bound:.5f} ms ({by}), "
                  f"{rec['share_of_bound']:.1%} of the device time",
                  flush=True)
        res[label] = shape
    probes.write_json(args.out, {"card": card, "iters": n,
                                 "seed": args.seed, "shapes": res})
    return 0


if __name__ == "__main__":
    sys.exit(main())
