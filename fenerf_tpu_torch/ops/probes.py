"""Measurement on the card for chip_smoke.py, the ceiling-probe scripts
(scripts/profile_torch_{mxu_chain,epilogue_overlap,dma_gather}.py) and the
ray kernels' script (scripts/profile_torch_ray_kernels.py): the card's name
and power limit, CUDA-event timing, device time from the profiler's kernel
durations, the host's time per call, the roofline bound; the probes' shapes
(those of the JAX scripts scripts/profile_{mxu_chain,epilogue_overlap,
dma_gather}.py) and seeded draws; the ray kernels' main-path shapes and
draws.
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import time
from pathlib import Path

import torch

H, LAYERS, N_PTS = 256, 11, 1 << 20           # the field's chain
WIDE_H, WIDE_LAYERS, WIDE_N = 512, 5, 1 << 19  # the same FLOPs per point
TABLE_ROWS, N_IDX = 97 ** 3, 1 << 18           # the gather
ROW_TPU = (8, 128)      # the TPU layout's 2 KB row
ROW_FLAGSHIP = (256,)   # the flagship table's 512 B row (8C, C = 32)

# NVIDIA H100 SXM data sheet, dense, at the full 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12     # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12


def require_cuda(name: str) -> torch.device:
    """The card, with the plain versions' precision pinned (F4): f32
    products in full f32, bf16 products reduced in f32."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{name}: needs an NVIDIA GPU (CUDA is not "
                           "available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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


def device_ms(fn, iters: int, kernel: str) -> float:
    """Mean device duration in ms of the kernels whose name contains
    `kernel`, per launch, over iters calls of fn (torch.profiler's CUDA
    kernel records: the kernel alone, without the host's dispatch or the
    gaps between launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a trace now and then comes back without the kernel records: trace
    # again (three times at most)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us, count = 0.0, 0
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA and kernel in evt.key:
                total_us += evt.self_device_time_total
                count += evt.count
        if count:
            return total_us / count / 1e3
    raise RuntimeError(f"device_ms: no CUDA kernel named *{kernel}* in "
                       "three traces")


def host_us(fn, iters: int) -> float:
    """The host's time per call of fn in µs: the enqueue alone, the device
    drained before and after (fewer calls than the launch queue holds)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def empty_launcher(blocks: int, threads: int = 128):
    """A function that launches an empty kernel of `blocks` CTAs of
    `threads` on the current stream (ops/csrc/ray_finalize.cu's
    empty_kernel, the floor under the ray kernels' times), or None when the
    library has none."""
    from fenerf_tpu_torch.ops import ray_finalize

    lib = ray_finalize._load_library()
    if not hasattr(lib, "ray_empty_launch"):
        return None
    fn = lib.ray_empty_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch():
        rc = fn(blocks, threads, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"empty kernel launch failed ({rc})")

    return launch


def bound_ms(flops: float, nbytes: float,
             peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations
    over their peak (bf16 tensor cores unless given) and the bytes over the
    memory rate."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def chain_cost(n: int, h: int, layers: int) -> tuple[int, int]:
    """(FLOPs, bytes) of a chain: the products; x read and out written
    once, the weights read once."""
    return 2 * n * h * h * layers, 2 * n * h * 2 + layers * h * h * 2


def chain_variant(tile: int, interleave: int) -> str:
    """A chain variant's name in the probe scripts: chain_t64, chain_t128,
    ilv2_t128."""
    return (f"chain_t{tile}" if interleave == 1
            else f"ilv{interleave}_t{tile}")


def wide_variant(tile: int) -> str:
    """A run_wide variant's name in the probe scripts: wide_t64,
    wide_t128."""
    return f"wide_t{tile}"


def gather_bytes(n: int, row_bytes: int) -> int:
    """Each index read, its row read and written."""
    return n * (2 * row_bytes + 4)


def report(name: str, ms: float, flops: float, nbytes: float,
           rows: int | None = None) -> dict:
    """Print one variant's line; return its record."""
    bound, by = bound_ms(flops, nbytes)
    rec = {"ms": ms, "bound_ms": bound, "bound_by": by,
           "share_of_bound": bound / ms, "tflops": flops / ms / 1e9,
           "gb_s": nbytes / ms / 1e6}
    rate = f"{rec['tflops']:.1f} TFLOP/s" if flops else \
        f"{rec['gb_s']:.0f} GB/s"
    if rows is not None:
        rec["mrows_s"] = rows / ms / 1e3
        rate += f", {rec['mrows_s']:.0f} Mrows/s"
    print(f"{name}: {ms:.4f} ms, {rate}, bound {bound:.4f} ms ({by}), "
          f"{rec['share_of_bound']:.1%} of it", flush=True)
    return rec


def activations(gen: torch.Generator, n: int, h: int,
                device) -> torch.Tensor:
    """The JAX scripts' x ~ N(0, 0.1^2), bf16 (n, h)."""
    return (torch.randn(n, h, generator=gen, device=device) * 0.1).bfloat16()


def chain_inputs(gen: torch.Generator, n: int, h: int, layers: int,
                 device) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX scripts' draw: x as activations(), W ~ N(0, 1/h), bf16."""
    w = (torch.randn(layers, h, h, generator=gen, device=device)
         / math.sqrt(h)).bfloat16()
    return activations(gen, n, h, device), w


def film_inputs(gen: torch.Generator, layers: int, h: int, device,
                scale: str = "script"):
    """(W, b, f, p) of a FiLM chain: f ~ N(30, 15^2), p ~ N(0, 1) in both
    scales. "script": the JAX script's W ~ N(0, 1/h), b ~ N(0, 0.1^2), a
    chain whose bf16 roundings grow without bound from layer 3 on.
    "field": the field's own SIREN scale W ~ U(+-sqrt(6/h)/30),
    b ~ U(+-1/sqrt(h)), which stays bounded over 11 layers."""
    if scale == "script":
        w = torch.randn(layers, h, h, generator=gen, device=device) \
            / math.sqrt(h)
        b = torch.randn(layers, h, generator=gen, device=device) * 0.1
    elif scale == "field":
        lim = math.sqrt(6 / h) / 30
        w = (torch.rand(layers, h, h, generator=gen, device=device) * 2 - 1) \
            * lim
        b = (torch.rand(layers, h, generator=gen, device=device) * 2 - 1) \
            / math.sqrt(h)
    else:
        raise ValueError(f"scale {scale!r}: 'script' or 'field'")
    f = torch.randn(layers, h, generator=gen, device=device) * 15 + 30
    p = torch.randn(layers, h, generator=gen, device=device)
    return w.bfloat16(), b, f, p


def table_inputs(gen: torch.Generator, row_shape, n: int, device
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """A (TABLE_ROWS,) + row_shape bf16 table drawn on the card, and n int32
    indices uniform over its rows."""
    table = torch.randn((TABLE_ROWS,) + tuple(row_shape), generator=gen,
                        device=device, dtype=torch.bfloat16)
    idx = torch.randint(0, TABLE_ROWS, (n,), generator=gen, device=device,
                        dtype=torch.int32)
    return table, idx


def write_json(path: str, result: dict) -> None:
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1) + "\n")
    print(f"wrote {out}", flush=True)


# The ray kernels' main-path shapes (label, B, R, S, sigma noise): one
# 4096-ray block of a 128^2 serve render at 48 steps, one training
# microbatch (6 fakes, 32^2, 24 steps), a ragged ray count whose blocks are
# not 16-byte multiples (37 x 22 floats)
RAY_SHAPES = (("serving", 1, 4096, 48, False), ("training", 6, 1024, 24, True),
              ("ragged", 3, 1001, 37, True))
N_OUT = 22   # the flagship field's outputs: 18 labels, rgb, sigma


def ray_inputs(gen: torch.Generator, device, b: int, r: int, s: int,
               c1: int = N_OUT):
    """Stratified z in [0.88, 1.12], sigma with half the rays opaque, and a
    maker of (B, R, n, c1) field outputs (channels in [0, 1), sigma last)."""
    z0 = torch.linspace(0.88, 1.12, s, device=device)
    z = z0 + torch.rand(b, r, s, generator=gen, device=device) * (0.24 / s)
    level = torch.where(
        torch.rand(b, r, 1, generator=gen, device=device) < 0.5, 20.0, -5.0)
    sigma = torch.randn(b, r, s, generator=gen, device=device) * 10 + level

    def outputs(n):
        return torch.cat([
            torch.rand(b, r, n, c1 - 1, generator=gen, device=device),
            torch.randn(b, r, n, 1, generator=gen, device=device) * 10
            + level[..., None]], dim=-1)

    return z, sigma, outputs


def ray_bounds(b: int, r: int, s: int, noisy: bool, c1: int = N_OUT
               ) -> tuple[tuple[float, str], tuple[float, str]]:
    """((ms, bound_by) of ray_resample, of ray_finalize) at S + S samples
    of c1 field outputs: every input read once, every output written once;
    a few dozen f32 operations per sample, 2 per channel and sample."""
    rows, t = b * r, 2 * s
    resample = bound_ms(rows * s * 40, 4 * rows * s * (4 + noisy),
                        PEAK_F32_FLOPS)
    finalize = bound_ms(rows * t * (2 * c1 + 30),
                        4 * rows * (t * (c1 + 1 + noisy) + c1 + 1),
                        PEAK_F32_FLOPS)
    return resample, finalize
