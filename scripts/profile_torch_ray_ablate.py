"""Where the ray kernels' device time goes, by removal, on one NVIDIA GPU.

  python scripts/profile_torch_ray_ablate.py [--iters 50] [--reps 2]
      [--out chiprun_out/profile_torch_ray_ablate.json]

Builds copies of ops/csrc/ray_finalize.cu, each with one part taken out,
into build/ray_ablate/ and times them against the unchanged kernels in one
process, in turns (base, variants..., variants reversed, base), at the
serving block and the training microbatch of ops/probes.py::RAY_SHAPES.
Each removal keeps its code behind a condition that is false at run time,
so the compiler cannot drop more than the part itself:

  base      the kernels as they are
  norank    ray_finalize without its rank count and bisection (every
            rank 0)
  nocomp    ray_finalize without its compositing loop
  nocopy    ray_finalize without its data copies: each stage's barrier
            arrives without bytes, the stage holds whatever it held
  nobisect  ray_finalize without the bisection of the fine z among the
            coarse samples
  noscan_f  ray_finalize without its prefix sum of log(1 - alpha)
  nofence   ray_finalize without the proxy fence before a stage's refill
  ring1     ray_finalize with one stage per warp instead of two (the same
            code; twice the warps fit in shared memory)
  nocount   ray_resample without its bisection of the uniforms (count 0)
  noscan    ray_resample without its three prefix sums

The variants compute wrong results by design; only their times mean
anything. Times are device times (torch.profiler's kernel durations).
Prints the median ms of each and writes them with the card's name and power
limit to --out. Needs CUDA and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from fenerf_tpu_torch.ops import build, probes  # noqa: E402
from fenerf_tpu_torch.ops import ray_finalize as rf  # noqa: E402

OUT_DIR = build.BUILD_DIR / "ray_ablate"


def _swap(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"ray_finalize.cu changed; not found once: {old!r}")
    return src.replace(old, new)


def variants(src: str) -> dict[str, tuple[str, str]]:
    """{name: (kernel it changes, source)}."""
    nocopy = _swap(src, "        hopper::mbar_arrive_expect_tx(&bars[s], "
                        "4u * (fe + ce));\n"
                        "        hopper::bulk_copy_g2s(st, f, 4u * fe, "
                        "&bars[s]);\n"
                        "        hopper::bulk_copy_g2s(st + fe, co, 4u * ce, "
                        "&bars[s]);\n",
                   "        hopper::mbar_arrive(&bars[s]);\n")
    nocopy = _swap(nocopy, "      for (int i = lane; i < fe; i += 32) "
                           "cp_async4(st + i, f + i);\n"
                           "      for (int i = lane; i < ce; i += 32) "
                           "cp_async4(st + fe + i, co + i);\n", "")
    noscan = src
    for call in ("  prefix_sum<SL>(lo, s, lane, true);\n",
                 "  prefix_sum<SL>(cdf, s, lane, false);\n  const float",
                 "  prefix_sum<SL>(cdf, s, lane, false);  // cdf_k"):
        noscan = _swap(noscan, call, "  if (rows < 0) " + call[2:])
    return {
        "base": ("both", src),
        "norank": ("ray_finalize", _swap(_swap(
            src, "const int jend = coarse_up ? P.sf : t;",
            "const int jend = P.rows < 0 ? t : 0;"),
            "if (coarse_up) {", "if (coarse_up && P.rows < 0) {")),
        "nocomp": ("ray_finalize", _swap(
            src, "for (int c0 = 0; c0 < c; c0 += 32) {",
            "for (int c0 = 0; c0 < c && P.rows < 0; c0 += 32) {")),
        "nocopy": ("ray_finalize", nocopy),
        "nobisect": ("ray_finalize", _swap(
            src, "if (coarse_up) {", "if (coarse_up && P.rows < 0) {")),
        "noscan_f": ("ray_finalize", _swap(
            src, "    prefix_sum<SL>(lo, t, lane, true);",
            "    if (P.rows < 0) prefix_sum<SL>(lo, t, lane, true);")),
        "nofence": ("ray_finalize", _swap(
            src, "    hopper::fence_proxy_async_smem();\n    __syncwarp();\n"
                 "    if (row + P.ring",
            "    __syncwarp();\n    if (row + P.ring")),
        "ring1": ("ray_finalize", _swap(src, "constexpr int RING = 2;",
                                        "constexpr int RING = 1;")),
        "nocount": ("ray_resample", _swap(
            src, "cnt[k] = count_below(cdf_row, m, uu[k]);",
            "cnt[k] = rows < 0 ? count_below(cdf_row, m, uu[k]) : 0;")),
        "noscan": ("ray_resample", noscan),
    }


def build_all(srcs: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """One nvcc per variant, all started together (build.command's flags)."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, src in srcs.items():
        cu = OUT_DIR / f"ray_finalize_{name}.cu"
        cu.write_text(src)
        so = OUT_DIR / f"ray_finalize_{name}.{os.getpid()}.so"
        jobs[name] = (so, subprocess.Popen(
            build.command(cu, so), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed:\n{out}")
        libs[name] = rf.bind(ctypes.CDLL(str(so)))
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default="chiprun_out/profile_torch_ray_ablate.json")
    args = ap.parse_args(argv)
    dev = probes.require_cuda("profile_torch_ray_ablate")
    card = probes.card()
    print(card, flush=True)
    src = (build.CSRC / "ray_finalize.cu").read_text()
    vs = variants(src)
    libs = build_all({k: s for k, (_, s) in vs.items()})
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {}
    for label, b, r, s, noisy in probes.RAY_SHAPES[:2]:
        z, sigma, outputs = probes.ray_inputs(gen, dev, b, r, s)
        randn = lambda k: torch.randn(b, r, k, generator=gen, device=dev)
        nz_c, nz_f = (randn(s), randn(2 * s)) if noisy else (None, None)
        u = torch.rand(b, r, s, generator=gen, device=dev)
        fo, co = outputs(s), outputs(s)
        fz = rf.ray_resample(sigma, z, nz_c, u)
        calls = {"ray_resample": (lambda: rf.ray_resample(sigma, z, nz_c, u),
                                  "ray_resample_kernel"),
                 "ray_finalize": (lambda: rf.ray_finalize(fo, co, fz, z,
                                                          nz_f),
                                  "ray_finalize_kernel")}
        order = list(vs)
        order = order + order[::-1]
        times: dict[str, list[float]] = {}
        for _ in range(args.reps):
            for name in order:
                rf._LIB = libs[name]
                for kernel, (fn, match) in calls.items():
                    if vs[name][0] in ("both", kernel):
                        times.setdefault(f"{kernel}_{name}", []).append(
                            probes.device_ms(fn, args.iters, match))
        rf._LIB = None
        res[label] = {k: statistics.median(v) for k, v in times.items()}
        for k, v in res[label].items():
            print(f"{label} {k}: {v:.4f} ms device (median of "
                  f"{len(times[k])})", flush=True)
    probes.write_json(args.out, {"card": card, "iters": args.iters,
                                 "reps": args.reps, "variants": res})
    return 0


if __name__ == "__main__":
    sys.exit(main())
