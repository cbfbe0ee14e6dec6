"""How the plain reference rounds the operands of its products.

The reference computes in float32 with TF32 off. Its control computes every
product one step below the precision the configuration states for it:
float32 -> TF32, bfloat16 -> fp8 (e4m3, one scale per tensor, as an fp8
product path scales its operands). `Products` names the rounding of each
product family; `round_to` applies one.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

# the step below each precision a configuration may state
LOWER = {"float32": "tfloat32", "bfloat16": "float8_e4m3"}
E4M3_MAX = 448.0


def _round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 `x` rounded to nearest-even at `bits` mantissa bits."""
    drop = 23 - bits
    i = x.float().contiguous().view(torch.int32)
    half = (1 << (drop - 1)) - 1
    odd = (i >> drop) & 1
    i = (i + half + odd) & ~((1 << drop) - 1)
    return i.view(torch.float32)


def _quantize(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tfloat32":
        return _round_mantissa(x, 10)
    if precision == "bfloat16":
        return x.to(torch.bfloat16).float()
    if precision == "float8_e4m3":
        x = x.float()
        scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
        return (x / scale).clamp(-E4M3_MAX, E4M3_MAX).to(
            torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {precision!r}")


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """`x` as float32 holding the values of `precision`; the gradient
    passes through the rounding unchanged."""
    if precision == "float32":
        return x.float()
    with torch.no_grad():
        q = _quantize(x, precision)
    return x + (q - x).detach() if x.requires_grad else q


class _Matmul(torch.autograd.Function):
    """x @ w on rounded operands, its backward's products on rounded
    operands too (the output cotangent rounded as the operands are)."""

    @staticmethod
    def forward(ctx, x, w, precision):
        xr, wr = _quantize(x, precision), _quantize(w, precision)
        ctx.save_for_backward(xr, wr)
        ctx.precision = precision
        return xr @ wr

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = _quantize(g, ctx.precision)
        dx = gr @ wr.T
        dw = xr.reshape(-1, xr.shape[-1]).T @ gr.reshape(-1, gr.shape[-1])
        return dx, dw, None


class Products(NamedTuple):
    """The precision of each product family of a configuration."""
    field: str = "float32"      # the FiLM layers (trunk and colour)
    heads: str = "float32"      # the density, label and colour heads
    table: str = "float32"      # texture features fed to the field
    mapping: str = "float32"    # latent and per-point mapping networks
    critics: str = "float32"    # the critics' convolutions

    def lowered(self) -> "Products":
        return Products(*(LOWER[p] for p in self))


EXACT = Products()


def configured(config: dict) -> Products:
    """The precisions a configuration file states (its "products")."""
    return Products(**config["products"])


def matmul(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x @ w with both operands rounded to `precision`, f32 accumulation
    (float32: the plain product)."""
    if precision == "float32":
        return x @ w
    return _Matmul.apply(x, w, precision)


@contextlib.contextmanager
def exact_float32():
    """cuBLAS and cuDNN without TF32: float32 products in float32."""
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    kept = (mm.allow_tf32, dnn.allow_tf32)
    mm.allow_tf32, dnn.allow_tf32 = False, False
    try:
        yield
    finally:
        mm.allow_tf32, dnn.allow_tf32 = kept
