"""The port's exact-precision policy: float32 convolutions and products in
full float32, as the JAX package computes them (ROADMAP F4).

cuDNN's and cuBLAS's TF32 are process-wide flags (torch allows TF32 in
cuDNN by default). Library code never sets them for the process: it enters
one of these contexts around the work that must be exact.

  exact_convs()                    cuDNN with TF32 off and deterministic
                                   algorithms only
  exact_convs(deterministic=False) cuDNN with TF32 off, its choice of
                                   algorithms as the process left it
  exact_matmuls()                  cuBLAS products with TF32 off

Deterministic algorithms keep a convolution the same function of its
inputs from call to call: cuDNN's default choice for the latent grid's
transposed convolution sums in a varying order (~1.5e-6 apart from call to
call on an H100, as scripts/profile_torch_grid_frame.py measures), and a
frame rendered in ray blocks must equal the frame rendered whole.

Autograd runs a backward after the forward's `with` has closed, on the
process's own flags. A caller that differentiates computes its loss and
its gradients inside one `with` (train/loop.py, R1's double backward too),
or wraps the op in a Function whose backward enters the context again
(ops/upfirdn2d.py::_ExactConv).
"""
from __future__ import annotations

import contextlib

import torch


def exact_convs(deterministic: bool = True):
    """cuDNN with TF32 off; with `deterministic`, deterministic algorithms
    and no benchmarking. cudnn.flags() alone would disable cuDNN (T6), so
    every setting is passed."""
    cudnn = torch.backends.cudnn
    benchmark, det = ((False, True) if deterministic
                      else (cudnn.benchmark, cudnn.deterministic))
    return cudnn.flags(enabled=cudnn.enabled, benchmark=benchmark,
                       deterministic=det, allow_tf32=False)


@contextlib.contextmanager
def exact_matmuls():
    """cuBLAS products with TF32 off, the process's flag restored after."""
    matmul = torch.backends.cuda.matmul
    kept = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = kept
