"""StyleGAN2-style layers and the 2-D latent-grid generator (port of
fenerf_tpu/nn/stylegan.py).

Modulated convolution follows the JAX package's shared-weight formulation:
modulation scales the input channels and demodulation the output channels
around ONE convolution with the shared weight,
    y[b] = demod[b, o] * conv(x[b] * gamma[b, i], w)
with demod computed from gamma and the per-(o, i) weight norms; the same
function as per-sample weights and grouped convolutions. Parameters keep
the JAX layouts (a conv weight is HWIO (kh, kw, in, out), a linear's
(in, out)), so a checkpoint copies across leaf for leaf. Every convolution
runs with TF32 off (ROADMAP F4) on cuDNN's deterministic algorithms
(ops/upfirdn2d.py::exact_convs), forward and backward.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from fenerf_tpu_torch.nn import init as winit
from fenerf_tpu_torch.ops.upfirdn2d import (blur, conv2d_f32,
                                            conv_transpose2d_f32,
                                            fused_leaky_relu, upsample2d)

Params = Any


def pixel_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + 1e-8) along `dim`."""
    return x * torch.rsqrt(torch.mean(x * x, dim=dim, keepdim=True) + 1e-8)


# ---------------------------------------------------------------------------
# Equalized-lr linear
# ---------------------------------------------------------------------------

def init_equal_linear(gen, in_ch, out_ch, device, lr_mul=1.0,
                      bias_init=0.0) -> Params:
    return {"w": winit.normal(gen, (in_ch, out_ch), device) / lr_mul,
            "b": torch.full((out_ch,), bias_init, device=device)}


def equal_linear(p: Params, x: torch.Tensor, lr_mul=1.0, activate=False):
    scale = (1.0 / math.sqrt(p["w"].shape[0])) * lr_mul
    y = x @ (p["w"] * scale)
    if activate:
        return fused_leaky_relu(y, p["b"] * lr_mul)
    return y + p["b"] * lr_mul


# ---------------------------------------------------------------------------
# Modulated conv (StyleGAN2), shared-weight formulation
# ---------------------------------------------------------------------------

def init_modulated_conv(gen, in_ch, out_ch, ksize, z_dim, device) -> Params:
    return {"w": winit.normal(gen, (ksize, ksize, in_ch, out_ch), device),
            "mod": init_equal_linear(gen, z_dim, in_ch, device,
                                     bias_init=1.0),
            "b": torch.zeros((out_ch,), device=device)}


def modulated_conv2d(p: Params, x: torch.Tensor, z: torch.Tensor,
                     demodulate: bool = True, upsample: bool = False,
                     downsample: bool = False, activate: bool = True,
                     bias: bool = True,
                     blur_kernel=(1, 3, 3, 1)) -> torch.Tensor:
    """x (B, C_in, H, W), z (B, z_dim) -> (B, C_out, H', W')."""
    ksize, _, in_ch, out_ch = p["w"].shape
    scale = 1.0 / math.sqrt(in_ch * ksize * ksize)
    gamma = equal_linear(p["mod"], z)            # (B, in)
    w = p["w"] * scale                           # (kh, kw, in, out)

    if demodulate:
        # demod[b, o] = rsqrt(sum_{i,k} (w[k, i, o] * gamma[b, i])^2)
        w2 = torch.sum(w * w, dim=(0, 1))        # (in, out)
        demod = torch.rsqrt((gamma * gamma) @ w2 + 1e-8)

    xm = x * gamma[:, :, None, None]
    w_oihw = w.permute(3, 2, 0, 1)

    if upsample:
        # the JAX package's lax.conv_transpose(transpose_kernel=True) on
        # the kernel laid out (kh, kw, out, in) is torch's transposed
        # convolution (stride 2, no padding) with the weight (in, out,
        # kh, kw)
        out = conv_transpose2d_f32(xm, w.permute(2, 3, 0, 1), stride=2)
        factor, klen = 2, len(blur_kernel)
        if ksize < factor:
            # lax's VALID transpose gives in * 2 samples where torch's gives
            # (in - 1) * 2 + ksize: zeros on the high side
            out = F.pad(out, (0, factor - ksize, 0, factor - ksize))
        pp = (klen - factor) - (ksize - 1)
        if demodulate:
            out = out * demod[:, :, None, None]
        out = blur(out, blur_kernel,
                   pad=((pp + 1) // 2 + factor - 1, pp // 2 + 1),
                   upsample_factor=factor)
    elif downsample:
        factor, klen = 2, len(blur_kernel)
        pp = (klen - factor) + (ksize - 1)
        xm = blur(xm, blur_kernel, pad=((pp + 1) // 2, pp // 2))
        out = conv2d_f32(xm, w_oihw, stride=2)
        if demodulate:
            out = out * demod[:, :, None, None]
    else:
        out = conv2d_f32(xm, w_oihw, padding=ksize // 2)
        if demodulate:
            out = out * demod[:, :, None, None]

    if activate:
        out = fused_leaky_relu(out, p["b"])
    elif bias:
        out = out + p["b"][None, :, None, None]
    return out


# ---------------------------------------------------------------------------
# StyleGenerator2D (the latent grid)
# ---------------------------------------------------------------------------

def _channels(ch_max: int, ch_mul: int) -> dict[int, int]:
    return {4: ch_max, 8: ch_max, 16: ch_max, 32: ch_max,
            64: ch_max // 2 * ch_mul, 128: ch_max // 4 * ch_mul,
            256: ch_max // 8 * ch_mul, 512: ch_max // 16 * ch_mul,
            1024: ch_max // 32 * ch_mul}


def init_style_generator_2d(gen, out_res=32, out_ch=32, z_dim=256,
                            ch_mul=1, ch_max=256, skip_conn=False,
                            device="cpu") -> Params:
    """Random StyleGenerator2D parameters in the JAX package's tree layout
    (the draws differ from jax.random's; the distributions match)."""
    channels = _channels(ch_max, ch_mul)
    params: dict[str, Any] = {
        "mapping": [init_equal_linear(gen, z_dim, z_dim, device, lr_mul=0.01)
                    for _ in range(3)],
        "input": winit.normal(gen, (channels[4], 4, 4), device),
        "conv1": init_modulated_conv(gen, channels[4], channels[4], 3, z_dim,
                                     device),
    }
    convs, rgbs = [], []
    in_ch, res = channels[4], 4
    while res < out_res:
        res *= 2
        oc = channels[res]
        convs.append(init_modulated_conv(gen, in_ch, oc, 3, z_dim, device))
        convs.append(init_modulated_conv(gen, oc, oc, 3, z_dim, device))
        if skip_conn:
            rgbs.append(init_modulated_conv(gen, oc, out_ch, 1, z_dim,
                                            device))
        in_ch = oc
    params["convs"] = convs
    if skip_conn:
        params["to_rgb1"] = init_modulated_conv(gen, channels[4], out_ch, 1,
                                                z_dim, device)
        params["to_rgbs"] = rgbs
    else:
        params["out_rgb"] = init_modulated_conv(gen, in_ch, out_ch, 1, z_dim,
                                                device)
    return params


def style_generator_2d(p: Params, z: torch.Tensor,
                       skip_conn: bool = False) -> torch.Tensor:
    """z (B, z_dim) -> feature grid (B, out_ch, out_res, out_res). Every
    conditional layer takes the one mapped w."""
    w = pixel_norm(z)
    for lyr in p["mapping"]:
        w = equal_linear(lyr, w, lr_mul=0.01, activate=True)

    b = z.shape[0]
    out = p["input"][None].expand((b,) + tuple(p["input"].shape))
    out = modulated_conv2d(p["conv1"], out, w)

    skip = None
    if skip_conn:
        skip = modulated_conv2d(p["to_rgb1"], out, w, demodulate=False,
                                activate=False)
    for i in range(0, len(p["convs"]), 2):
        out = modulated_conv2d(p["convs"][i], out, w, upsample=True)
        out = modulated_conv2d(p["convs"][i + 1], out, w)
        if skip_conn:
            rgb = modulated_conv2d(p["to_rgbs"][i // 2], out, w,
                                   demodulate=False, activate=False)
            skip = rgb + upsample2d(skip)
    if not skip_conn:
        skip = modulated_conv2d(p["out_rgb"], out, w, demodulate=False,
                                activate=False)
    return skip
