"""Texture-table cotangent fold: the Python side of the CUDA kernel (port of
the Pallas kernel fenerf_tpu/ops/zexp_fold.py::fold_zexp).

The adjoint of the z-expanded table build folds a table cotangent
((D+1)(H+1)(W+1), 8C) into the grid gradient (C, D, H, W): every output
element is the f32 sum of 8 shifted table entries. The kernel
(ops/csrc/zexp_fold.cu) computes each output directly as that 8-term sum, in
the plain version's term order, so the two agree bit for bit.

Dispatch: `fold_zexp` runs `fold_zexp_reference` for CPU tensors and the
CUDA kernel for CUDA tensors, or raises; it never falls back. Callers reach
it through core/grid_sample.py::zexp_table_adjoint, which sends every
tensor off the CPU here (the trainer's fold, the table build's backward).
"""
from __future__ import annotations

import ctypes

import torch

from fenerf_tpu_torch.core import grid_sample as gs
from fenerf_tpu_torch.ops import build


def fold_zexp_reference(dtable: torch.Tensor, grid_shape) -> torch.Tensor:
    """The plain torch version: the 8-slice fold of
    grid_sample.zexp_table_adjoint_torch, f32 out."""
    fold_zexp_reference.calls += 1
    return gs.zexp_table_adjoint_torch(dtable, grid_shape)


fold_zexp_reference.calls = 0

_LIB = None


def _load_library():
    """ops/csrc/zexp_fold.cu, built for sm_90a into build/ and loaded."""
    global _LIB
    if _LIB is None:
        lib = build.library("zexp_fold")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fold_zexp_forward.argtypes = [vp, vp] + [ci] * 5 + [vp]
        lib.fold_zexp_forward.restype = ci
        lib.zexp_fold_error_string.argtypes = [ci]
        lib.zexp_fold_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def fold_zexp(dtable: torch.Tensor, grid_shape) -> torch.Tensor:
    """Fold a table cotangent ((D+1)(H+1)(W+1), 8C), f32 or bf16, into the
    grid cotangent (C, D, H, W) in f32.

    CPU tensors take fold_zexp_reference; CUDA tensors launch the sm_90a
    kernel (ops/csrc/zexp_fold.cu) or raise."""
    if dtable.device.type == "cpu":
        return fold_zexp_reference(dtable, grid_shape)
    if dtable.device.type != "cuda":
        raise ValueError(f"fold_zexp: no kernel for device {dtable.device}")
    c, d, h, w = (int(n) for n in grid_shape)
    shape = ((d + 1) * (h + 1) * (w + 1), 8 * c)
    if dtable.dtype not in (torch.float32, torch.bfloat16) \
            or tuple(dtable.shape) != shape or not dtable.is_contiguous():
        raise ValueError(
            f"fold_zexp: dtable must be a contiguous float32 or bfloat16 "
            f"tensor of shape {shape}; got {dtable.dtype} "
            f"{tuple(dtable.shape)} (contiguous={dtable.is_contiguous()})")
    if not 1 <= c <= 256 or max(d, h) > 65535:
        raise ValueError(f"fold_zexp: grid {grid_shape} not covered "
                         "(C <= 256, D and H <= 65535)")
    out = torch.empty(c, d, h, w, dtype=torch.float32, device=dtable.device)
    lib = _load_library()
    rc = lib.fold_zexp_forward(
        dtable.data_ptr(), out.data_ptr(), c, d, h, w,
        int(dtable.dtype == torch.bfloat16),
        torch.cuda.current_stream(dtable.device).cuda_stream)
    if rc != 0:
        msg = lib.zexp_fold_error_string(rc).decode()
        raise RuntimeError(f"fold_zexp kernel launch failed: {msg} ({rc})")
    fold_zexp.launches += 1
    return out


fold_zexp.launches = 0
