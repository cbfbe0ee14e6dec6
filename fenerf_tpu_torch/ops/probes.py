"""Measurement on the card for chip_smoke.py and the ceiling-probe scripts
(scripts/profile_torch_{mxu_chain,epilogue_overlap,dma_gather}.py): the
card's name and power limit, CUDA-event timing, the roofline bound; and the
probes' shapes (those of the JAX scripts scripts/profile_{mxu_chain,
epilogue_overlap,dma_gather}.py) and seeded draws.
"""
from __future__ import annotations

import json
import math
import subprocess
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
