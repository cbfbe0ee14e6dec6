"""Plain progressive-growing CoordConv residual critic of pi-GAN / FENeRF
(discriminators.py, the double-encoder CCS critic that FENeRF's D_img and
D_seg are), in float32.

Seven residual blocks widen 32 -> 64 -> 128 -> 256 -> 400 (x4); each block
appends two coordinate channels before each of its 3x3 convolutions, the
second one strided, and adds a strided 1x1 skip, the sum over sqrt 2. The
input resolution picks the entry block (one 1x1 adapter per resolution);
with alpha < 1 the first block's output fades in against the next adapter
on the input subsampled by 2. A final 2x2 convolution gives [score | z_geo
(256) | z_app (256) | pose (2)]. Weights are HWIO.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.precision import round_to


def _conv(x, p, precision, stride=1, pad=0):
    w = p["w"].permute(3, 2, 0, 1)
    return F.conv2d(round_to(x, precision), round_to(w, precision), p["b"],
                    stride=stride, padding=pad)


def _coords(x):
    b, _, h, w = x.shape
    rows = torch.linspace(-1.0, 1.0, h, device=x.device, dtype=x.dtype)
    cols = torch.linspace(-1.0, 1.0, w, device=x.device, dtype=x.dtype)
    return torch.cat([x, rows[None, None, :, None].expand(b, 1, h, w),
                      cols[None, None, None, :].expand(b, 1, h, w)], 1)


def critic(params, images, alpha, precision="float32"):
    """images (B, C, H, W) in [-1, 1] -> (score (B, 1), z_geo, z_app,
    pose (B, 2)); the two latents share the head's width."""
    lrelu = lambda t: F.leaky_relu(t, 0.2)
    size = images.shape[-1]
    start = 8 - int(math.log2(size))
    h = lrelu(_conv(images, params["from_rgb"][start], precision))
    for i, bi in enumerate(range(start, len(params["blocks"]))):
        if i == 1:
            skip = lrelu(_conv(images[:, :, ::2, ::2],
                               params["from_rgb"][start + 1], precision))
            h = alpha * h + (1.0 - alpha) * skip
        p = params["blocks"][bi]
        y = lrelu(_conv(_coords(h), p["conv1"], precision, pad=1))
        y = lrelu(_conv(_coords(y), p["conv2"], precision, stride=2, pad=1))
        h = (y + _conv(h, p["proj"], precision, stride=2)) / math.sqrt(2.0)
    out = _conv(h, params["final"], precision).reshape(images.shape[0], -1)
    latent = (out.shape[1] - 3) // 2
    return (out[:, :1], out[:, 1:1 + latent],
            out[:, 1 + latent:1 + 2 * latent], out[:, 1 + 2 * latent:])
