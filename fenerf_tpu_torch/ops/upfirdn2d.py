"""StyleGAN2 resampling and the fused activation (port of
fenerf_tpu/ops/upfirdn2d.py).

  fused_leaky_relu(x, bias) = leaky_relu(x + bias[per channel]) * sqrt(2)
  upfirdn2d(x, k, up, down, pad) = zero-upsample by `up` -> pad -> 2-D
      convolution with the flipped kernel -> stride `down`.

As in the JAX package, each resample is one depthwise convolution
(F.conv2d with groups = channels); the zero-upsampling is written out
before it, `up - 1` zeros after every sample, the JAX package's padding
rule. The convolutions (these and nn/stylegan.py's) run with TF32 off
(ROADMAP F4) and cuDNN's deterministic algorithms (exact_convs), in the
forward and in the backward the trainer's G phase runs through them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor | None = None,
                     negative_slope: float = 0.2,
                     scale: float = math.sqrt(2.0)) -> torch.Tensor:
    """Bias (per channel: NCHW dim 1, or a linear's last dim) +
    LeakyReLU, times scale."""
    if bias is not None:
        if x.ndim == 2:
            x = x + bias[None, :]
        else:
            x = x + bias.reshape((1, bias.shape[0]) + (1,) * (x.ndim - 2))
    return F.leaky_relu(x, negative_slope) * scale


def make_kernel(k, gain: float = 1.0, device="cpu") -> torch.Tensor:
    """1-D taps -> the normalized outer-product 2-D FIR kernel."""
    k = torch.as_tensor(k, dtype=torch.float32, device=device)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    return k / k.sum() * gain


def exact_convs():
    """cuDNN with TF32 off (F4) and deterministic algorithms only: the
    latent plane must be the same function of z at every call (cuDNN's
    default choice for the transposed convolution sums in a varying order:
    ~1.5e-6 apart from call to call on an H100, as
    scripts/profile_torch_grid_frame.py measures), so that a frame
    rendered in ray blocks equals the frame rendered whole. cudnn.flags()
    alone would disable cuDNN (T6)."""
    return torch.backends.cudnn.flags(
        enabled=torch.backends.cudnn.enabled, benchmark=False,
        deterministic=True, allow_tf32=False)


def _conv_backward(*args):
    """aten's convolution backward (a name of its own, so that a test can
    watch the settings it runs under)."""
    return torch.ops.aten.convolution_backward(*args)


class _ExactConv(torch.autograd.Function):
    """A bias-free F.conv2d or F.conv_transpose2d under exact_convs() in
    both directions. Autograd runs a backward after the forward's `with`
    has closed, on the process's own cuDNN settings (TF32 on by torch's
    default), so the backward enters exact_convs() again."""

    @staticmethod
    def forward(ctx, x, w, stride: int, padding: int, groups: int,
                transposed: bool):
        ctx.save_for_backward(x, w)
        ctx.conv = (stride, padding, groups, transposed)
        op = F.conv_transpose2d if transposed else F.conv2d
        with exact_convs():
            return op(x, w, stride=stride, padding=padding, groups=groups)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        stride, padding, groups, transposed = ctx.conv
        with exact_convs():
            dx, dw, _ = _conv_backward(
                grad.contiguous(), x, w, None, [stride] * 2, [padding] * 2,
                [1, 1], transposed, [0, 0], groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw, None, None, None, None


def conv2d_f32(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
               padding: int = 0, groups: int = 1) -> torch.Tensor:
    """F.conv2d (no bias) under exact_convs(), its backward too."""
    return _ExactConv.apply(x, w, stride, padding, groups, False)


def conv_transpose2d_f32(x: torch.Tensor, w: torch.Tensor,
                         stride: int = 1) -> torch.Tensor:
    """F.conv_transpose2d (no bias, no padding) under exact_convs(), its
    backward too."""
    return _ExactConv.apply(x, w, stride, 0, 1, True)


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1,
              down: int = 1, pad: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """(B, C, H, W) resample: one depthwise convolution."""
    b, c, h, w = x.shape
    p0, p1 = pad
    if p0 < 0 or p1 < 0:
        raise NotImplementedError("negative upfirdn2d padding")
    if up > 1:
        # up - 1 zeros after EVERY sample: (n * up) samples per axis
        xu = x.new_zeros(b, c, h * up, w * up)
        xu[:, :, ::up, ::up] = x
        x = xu
    x = F.pad(x, (p0, p1, p0, p1))
    # correlation with the flipped kernel is the true convolution
    k = torch.flip(kernel, (0, 1)).to(x.dtype)
    k = k[None, None].expand(c, 1, *k.shape).contiguous()
    return conv2d_f32(x, k, stride=down, groups=c)


def upsample2d(x: torch.Tensor, kernel=(1, 3, 3, 1),
               factor: int = 2) -> torch.Tensor:
    """StyleGAN2's Upsample: gain factor^2."""
    k = make_kernel(kernel, gain=factor * factor, device=x.device)
    p = k.shape[0] - factor
    return upfirdn2d(x, k, up=factor, pad=((p + 1) // 2 + factor - 1,
                                           p // 2))


def downsample2d(x: torch.Tensor, kernel=(1, 3, 3, 1),
                 factor: int = 2) -> torch.Tensor:
    """StyleGAN2's Downsample."""
    k = make_kernel(kernel, device=x.device)
    p = k.shape[0] - factor
    return upfirdn2d(x, k, down=factor, pad=((p + 1) // 2, p // 2))


def blur(x: torch.Tensor, kernel=(1, 3, 3, 1), pad=(0, 0),
         upsample_factor: int = 1) -> torch.Tensor:
    """StyleGAN2's Blur."""
    gain = upsample_factor ** 2 if upsample_factor > 1 else 1.0
    return upfirdn2d(x, make_kernel(kernel, gain=gain, device=x.device),
                     pad=pad)
