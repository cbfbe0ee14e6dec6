"""Scattered-row gather: the Python side of the CUDA kernel in
ops/csrc/dma_gather.cu (port of the Pallas kernel
scripts/profile_dma_gather.py::ring_dma_gather).

`ring_dma_gather(table, idx, ring)` returns table[idx]: each CTA owns
TILE indices and keeps at most `ring` rows in flight (a power of two that
shared memory holds), each moved by one bulk copy in and one out. With
overlap it also runs the bf16 chain of ops/mxu_chain.py over an (n, h)
activation in the same kernel and returns that too (the TPU kernel
computes it into a second output; its activation is all zeros, the port's
defaults to zeros).

The table keeps the TPU layout (rows, 8, 128) at the public function, but
any (rows, ...) bf16 table whose row is a multiple of 16 bytes is taken:
the flagship's own 512-byte row ((D+1)(H+1)(W+1), 8C), which
core/grid_sample.py gathers, included.

Dispatch: the wrapper checks its inputs, runs `gather_reference`
(index_select, and chain_reference for the overlap) for CPU tensors and the
CUDA kernel for CUDA tensors, or raises; it never falls back. An index
outside [0, rows) gives a row of zeros on the card (index_select raises).
"""
from __future__ import annotations

import ctypes
import math

import torch

from fenerf_tpu_torch.ops import build
from fenerf_tpu_torch.ops import mxu_chain

TILE = 1024              # indices per CTA (ops/csrc/dma_gather.cu)
_CHAIN_ROWS = 64         # the overlapped chain's sub-tile


def rings(row_bytes: int, overlap: bool = False, h: int = 256) -> tuple:
    """Every `ring` the kernel takes for this row size: the powers of two
    from 1 up to what a CTA's shared memory holds."""
    out, ring = [], 1
    while gather_smem(row_bytes, ring, h, overlap) <= mxu_chain.MAX_SMEM:
        out.append(ring)
        ring *= 2
    return tuple(out)


def gather_smem(row_bytes: int, ring: int, h: int, overlap: bool) -> int:
    """A CTA's shared memory (dma_gather.cu::dma_gather_smem): the tile's
    indices, `ring` row slots with a barrier each, and with overlap the
    chain's sub-tile."""
    return TILE * 4 + ring * (row_bytes + 8) + (
        mxu_chain.group_smem(_CHAIN_ROWS, h, 8) if overlap else 0)


def gather_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain torch version: table[idx] by index_select."""
    gather_reference.calls += 1
    return table.index_select(0, idx)


gather_reference.calls = 0

_LIB = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from
    ops/csrc/dma_gather.cu on `lib`."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.dma_gather_forward.argtypes = [
        vp, ctypes.c_longlong, vp, ci, ci, ci, vp, vp, vp, ci, ci, vp, ci,
        vp]
    lib.dma_gather_forward.restype = ci
    lib.dma_gather_rw.argtypes = [ci] * 3
    lib.dma_gather_rw.restype = ci
    lib.dma_gather_smem.argtypes = [ci] * 4
    lib.dma_gather_smem.restype = ci
    lib.dma_gather_error_string.argtypes = [ci]
    lib.dma_gather_error_string.restype = ctypes.c_char_p
    return lib


def _load_library():
    """ops/csrc/dma_gather.cu, built for sm_90a into build/ and loaded."""
    global _LIB
    if _LIB is None:
        _LIB = bind(build.library("dma_gather"))
    return _LIB


def _check(table, idx, ring, ws, x, overlap):
    """Raise on what the kernel does not take; return (x, stacked ws)."""
    if table.dtype != torch.bfloat16 or table.dim() < 2 \
            or not table.is_contiguous():
        raise ValueError(f"ring_dma_gather: table must be a contiguous "
                         f"(rows, ...) bfloat16 tensor; got {table.dtype} "
                         f"{tuple(table.shape)}")
    row_bytes = math.prod(table.shape[1:]) * 2
    if row_bytes % 16 or table.data_ptr() % 16:
        raise ValueError(f"ring_dma_gather: a table row is {row_bytes} "
                         "bytes; it must be a multiple of 16, 16-byte "
                         "aligned")
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous() \
            or idx.device != table.device or idx.shape[0] < 1:
        raise ValueError(f"ring_dma_gather: idx must be a contiguous 1-D "
                         f"int32 tensor of n >= 1 indices on {table.device}; "
                         f"got {idx.dtype} {tuple(idx.shape)} on {idx.device}")
    w = None
    if overlap:
        if ws is None:
            raise ValueError("ring_dma_gather: overlap needs ws")
        if x is None:
            h = (ws.shape[-1] if isinstance(ws, torch.Tensor)
                 else ws[0].shape[-1])
            x = torch.zeros(idx.shape[0], h, dtype=torch.bfloat16,
                            device=table.device)
        if x.shape[:1] != idx.shape or x.device != table.device:
            raise ValueError(f"ring_dma_gather: x must have one row per "
                             f"index ({idx.shape[0]}) on {table.device}; got "
                             f"{tuple(x.shape)} on {x.device}")
        # the chain's shared memory is part of the ring's check below
        mxu_chain._check_x("ring_dma_gather", x, mxu_chain.MAX_WIDE_WIDTH)
        w = mxu_chain._stack(ws, x.shape[1], x.device, "ring_dma_gather")
    h = x.shape[1] if overlap else 256
    if ring not in rings(row_bytes, overlap, h):
        raise ValueError(f"ring_dma_gather: ring {ring} not covered for "
                         f"{row_bytes}-byte rows (overlap={overlap}): one of "
                         f"{rings(row_bytes, overlap, h)}")
    return x, w


def ring_dma_gather(table: torch.Tensor, idx: torch.Tensor, ring: int = 64,
                    ws=None, x: torch.Tensor | None = None,
                    overlap: bool = False):
    """table[idx] ((n,) + table.shape[1:], bf16); with overlap, the pair
    (table[idx], the chain of x (n, h) bf16 through ws)."""
    x, w = _check(table, idx, ring, ws, x, overlap)
    if table.device.type == "cpu":
        rows = gather_reference(table, idx)
        return (rows, mxu_chain.chain_reference(x, w)) if overlap else rows
    if table.device.type != "cuda":
        raise ValueError(f"ring_dma_gather: no kernel for device "
                         f"{table.device}")
    n = idx.shape[0]
    out = torch.empty((n,) + tuple(table.shape[1:]), dtype=table.dtype,
                      device=table.device)
    act = torch.empty_like(x) if overlap else None
    lib = _load_library()
    rc = lib.dma_gather_forward(
        table.data_ptr(), table.shape[0], idx.data_ptr(), n,
        math.prod(table.shape[1:]) * 2, ring, out.data_ptr(),
        x.data_ptr() if overlap else None, w.data_ptr() if overlap else None,
        x.shape[1] if overlap else 0, w.shape[0] if overlap else 0,
        act.data_ptr() if overlap else None, int(overlap),
        torch.cuda.current_stream(table.device).cuda_stream)
    if rc != 0:
        msg = lib.dma_gather_error_string(rc).decode()
        raise RuntimeError(f"ring_dma_gather kernel launch failed: {msg} "
                           f"({rc})")
    ring_dma_gather.launches += 1
    return (out, act) if overlap else out


ring_dma_gather.launches = 0
