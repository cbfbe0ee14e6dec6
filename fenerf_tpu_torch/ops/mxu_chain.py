"""The field's ceiling probes: the Python side of the CUDA kernels in
ops/csrc/mxu_chain.cu (ports of the Pallas kernels
scripts/profile_mxu_chain.py::run_chain / run_wide and
scripts/profile_epilogue_overlap.py::run_epi).

  run_chain / run_wide   a <- bf16(a @ W[i]) for every layer: the fused
                         field's chain of products alone (run_wide is the
                         same function, run by the probe scripts at width 512)
  run_epi                a <- bf16(fast_sin(f[i] * (a @ W[i] + b[i]) + p[i]));
                         with fold, a <- bf16(fast_sin(a @ bf16(W[i] *
                         bf16(f[i])) + (f[i] * b[i] + p[i])))

Products take bf16 operands with f32 accumulation; every layer's output is
rounded to bf16 (round to nearest even). `tile` is a CTA's rows (32, 64 or
128) and `interleave` the number of independent warp groups it splits
them into (the TPU kernel's k-way row interleave); neither changes the
result.

Dispatch: a wrapper checks its inputs, runs its plain version
(`chain_reference`, `epi_reference`) for CPU tensors and the CUDA kernel
for CUDA tensors, or raises; it never falls back. Weights are a sequence
of (h, h) bf16 tensors, as the JAX scripts pass them, or one (layers, h, h)
tensor.
"""
from __future__ import annotations

import ctypes

import torch

from fenerf_tpu_torch.ops import build
from fenerf_tpu_torch.ops.fast_math import fast_sin

TILES = (32, 64, 128)
INTERLEAVES = (1, 2, 4)
MAX_WIDTH = 512
MAX_SMEM = 232_448      # a CTA's dynamic shared memory on an H100
_KC, _WM, _WN, _WARPS = 32, 32, 64, 8   # ops/csrc/chain.cuh
_EPI = {"none": 0, "film": 1, "fold": 2}


def _align128(x: int) -> int:
    return (x + 127) & ~127


def group_smem(rows: int, h: int, warps: int) -> int:
    """Shared memory of one warp group (ops/csrc/chain.cuh::group_layout):
    two activation buffers, two weight chunks, per-warp epilogue tiles."""
    nc = warps // (rows // _WM) * _WN
    off = _align128(rows * (h + 8) * 2)
    off = _align128(off + rows * (h + 8) * 2)
    off = _align128(off + _KC * (nc + 8) * 2)
    off = _align128(off + _KC * (nc + 8) * 2)
    return _align128(off + warps * 256 * 4)


def chain_smem(tile: int, interleave: int, h: int) -> int:
    """A chain CTA's shared memory (ops/csrc/mxu_chain.cu::mxu_chain_smem)."""
    return interleave * group_smem(tile // interleave, h,
                                   _WARPS // interleave)


def _stack(ws, h: int, device, name: str) -> torch.Tensor:
    w = ws if isinstance(ws, torch.Tensor) else torch.stack(list(ws))
    if w.dtype != torch.bfloat16 or w.dim() != 3 or w.shape[0] < 1 \
            or tuple(w.shape[1:]) != (h, h) or w.device != device:
        raise ValueError(
            f"{name}: ws must be (h, h) bfloat16 weights (or one (layers, h, "
            f"h) tensor) on {device} with h = {h}; got {w.dtype} "
            f"{tuple(w.shape)} on {w.device}")
    return w.contiguous()


def _check(name: str, x: torch.Tensor, ws, tile: int,
           interleave: int) -> torch.Tensor:
    """Raise on what the kernel does not take; return the stacked weights."""
    if x.dtype != torch.bfloat16 or x.dim() != 2 or not x.is_contiguous() \
            or x.shape[0] < 1:
        raise ValueError(f"{name}: x must be a contiguous (n, h) bfloat16 "
                         f"tensor with n >= 1; got {x.dtype} "
                         f"{tuple(x.shape)} (contiguous={x.is_contiguous()})")
    h = x.shape[1]
    if h % 64 or not 64 <= h <= MAX_WIDTH:
        raise ValueError(f"{name}: width h={h} not covered (a multiple of "
                         f"64, at most {MAX_WIDTH})")
    if tile not in TILES or interleave not in INTERLEAVES \
            or tile % interleave or (tile // interleave) % _WM:
        raise ValueError(f"{name}: tile {tile} / interleave {interleave} not "
                         f"covered (tile in {TILES}, tile / interleave a "
                         f"multiple of {_WM})")
    if chain_smem(tile, interleave, h) > MAX_SMEM:
        raise ValueError(f"{name}: tile {tile}, interleave {interleave} at "
                         f"width {h} needs {chain_smem(tile, interleave, h)} "
                         f"bytes of shared memory (at most {MAX_SMEM})")
    return _stack(ws, h, x.device, name)


def _check_film(x: torch.Tensor, layers: int, **vecs) -> None:
    for key, v in vecs.items():
        if v.dtype != torch.float32 or tuple(v.shape) != (layers, x.shape[1]) \
                or not v.is_contiguous() or v.device != x.device:
            raise ValueError(
                f"run_epi: {key} must be a contiguous ({layers}, "
                f"{x.shape[1]}) float32 tensor on {x.device}; got {v.dtype} "
                f"{tuple(v.shape)} on {v.device}")


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round f32 to bf16 and hold it in f32 again (T1: products of bf16
    values in f32, never a bf16 matmul in torch)."""
    return t.to(torch.bfloat16).float()


def chain_reference(x: torch.Tensor, ws) -> torch.Tensor:
    """The plain torch version of run_chain / run_wide: bf16 values held in
    f32, an f32 product, rounded to bf16 after every layer."""
    chain_reference.calls += 1
    a = x.float()
    for w in ws:
        a = _bf16(a @ w.float())
    return a.to(torch.bfloat16)


chain_reference.calls = 0


def epi_reference(x: torch.Tensor, ws, bs: torch.Tensor, f: torch.Tensor,
                  p: torch.Tensor, fold: bool = False) -> torch.Tensor:
    """The plain torch version of run_epi, in the JAX kernel's order
    (scripts/profile_epilogue_overlap.py:64-82): with fold, the scaled
    weights bf16(W * bf16(f)) are formed in bf16 (the product of two bf16
    values is exact in f32, so rounding it once gives the bf16 product)."""
    epi_reference.calls += 1
    a = x.float()
    for i, w in enumerate(ws):
        if fold:
            y = a @ _bf16(w.float() * _bf16(f[i]))
            a = _bf16(fast_sin(y + (f[i] * bs[i] + p[i])))
        else:
            a = _bf16(fast_sin(f[i] * (a @ w.float() + bs[i]) + p[i]))
    return a.to(torch.bfloat16)


epi_reference.calls = 0

_LIB = None


def _load_library():
    """ops/csrc/mxu_chain.cu, built for sm_90a into build/ and loaded."""
    global _LIB
    if _LIB is None:
        lib = build.library("mxu_chain")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.mxu_chain_forward.argtypes = [vp] * 8 + [ci] * 6 + [vp]
        lib.mxu_chain_forward.restype = ci
        lib.mxu_chain_smem.argtypes = [ci] * 3
        lib.mxu_chain_smem.restype = ci
        lib.mxu_chain_error_string.argtypes = [ci]
        lib.mxu_chain_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(name, x, w, tile, interleave, epi="none", b=None, f=None,
            p=None) -> torch.Tensor:
    n, h = x.shape
    layers = w.shape[0]
    out = torch.empty_like(x)
    ws = q = None
    if epi == "fold":   # scratch for the scaled weights and f * b + p
        ws, q = torch.empty_like(w), torch.empty_like(p)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _load_library()
    rc = lib.mxu_chain_forward(
        x.data_ptr(), w.data_ptr(), ptr(b), ptr(f), ptr(p), ptr(ws), ptr(q),
        out.data_ptr(), n, h, layers, tile, interleave, _EPI[epi],
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        msg = lib.mxu_chain_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")
    return out


def _device(name: str, x: torch.Tensor) -> bool:
    """True for CUDA (launch), False for the CPU (plain version)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return x.device.type == "cuda"


def run_chain(x: torch.Tensor, ws, tile: int = 64,
              interleave: int = 1) -> torch.Tensor:
    """x (n, h) bf16 through the bf16 chain of ws; (n, h) bf16."""
    w = _check("run_chain", x, ws, tile, interleave)
    if not _device("run_chain", x):
        return chain_reference(x, w)
    out = _launch("run_chain", x, w, tile, interleave)
    run_chain.launches += 1
    return out


run_chain.launches = 0


def run_wide(x: torch.Tensor, ws, tile: int = 64) -> torch.Tensor:
    """The same chain as run_chain (the probe scripts run it at width 512, 5
    layers: the FLOPs per point of the 11-layer chain at 256)."""
    w = _check("run_wide", x, ws, tile, 1)
    if not _device("run_wide", x):
        return chain_reference(x, w)
    out = _launch("run_wide", x, w, tile, 1)
    run_wide.launches += 1
    return out


run_wide.launches = 0


def run_epi(x: torch.Tensor, ws, bs: torch.Tensor, f: torch.Tensor,
            p: torch.Tensor, tile: int = 64, interleave: int = 1,
            fold: bool = False) -> torch.Tensor:
    """x (n, h) bf16 through the FiLM-sine chain (bs, f, p: (layers, h)
    f32); (n, h) bf16."""
    w = _check("run_epi", x, ws, tile, interleave)
    _check_film(x, w.shape[0], bs=bs, f=f, p=p)
    if not _device("run_epi", x):
        return epi_reference(x, w, bs, f, p, fold=fold)
    out = _launch("run_epi", x, w, tile, interleave,
                  "fold" if fold else "film", bs, f, p)
    run_epi.launches += 1
    return out


run_epi.launches = 0
