"""Progressive-growing CoordConv residual discriminators (port of the CCS
double-encoder critics of fenerf_tpu/nn/discriminators.py that the trainer
uses).

A pyramid of 7 residual CoordConv blocks (32 -> 64 -> 128 -> 256 -> 400 x4),
a 1x1 fromRGB adapter per input resolution, fade-in blending one level down,
and a final 2x2 conv emitting [score(1) | z_geo | z_app | pose(2)].

Parameters keep the JAX layout (HWIO conv weights), so trees copy across
leaf for leaf (compat/jax_bridge.py); each conv permutes to OIHW. Images
are NCHW. Every conv runs with cuDNN's TF32 off: float32 convolutions in
full float32, as the JAX package's; the trainer keeps it off in their
backward (utils/precision.py::exact_convs).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from fenerf_tpu_torch.nn import init as winit
from fenerf_tpu_torch.utils.precision import exact_convs

Params = Any

_CHANNELS = (32, 64, 128, 256, 400, 400, 400, 400)  # pyramid widths
_N_BLOCKS = 7


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    input_dim: int = 3          # 3 for D_img; 18+3 for D_seg
    latent_geo_dim: int = 256   # 0 => score-only
    latent_app_dim: int = 256   # 0 with latent_geo>0 => single-encoder
    coord_conv: bool = True     # False => plain strided convs

    @property
    def head_dim(self) -> int:
        if not (self.latent_geo_dim or self.latent_app_dim):
            return 1
        return 1 + self.latent_geo_dim + self.latent_app_dim + 2


def init_discriminator(gen: torch.Generator, cfg: DiscriminatorConfig,
                       device="cpu") -> Params:
    """Random parameters in the JAX tree layout, drawn from `gen` (the
    draws differ from jax.random's; the distributions match)."""
    extra = 2 if cfg.coord_conv else 0
    blocks = []
    for i in range(_N_BLOCKS):
        cin, cout = _CHANNELS[i], _CHANNELS[i + 1]
        blocks.append({
            "conv1": winit.conv2d_kaiming_leaky(gen, cin + extra, cout, 3,
                                                device),
            "conv2": winit.conv2d_kaiming_leaky(gen, cout + extra, cout, 3,
                                                device),
            "proj": winit.conv2d(gen, cin, cout, 1, device),
        })
    from_rgb = [winit.conv2d(gen, cfg.input_dim, c, 1, device)
                for c in _CHANNELS]
    final = winit.conv2d(gen, 400, cfg.head_dim, 2, device)
    return {"blocks": blocks, "from_rgb": from_rgb, "final": final}


def _conv(x, p, stride=1, pad=0):
    """NCHW conv with an HWIO weight and symmetric padding, TF32 off."""
    with exact_convs(deterministic=False):
        return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"],
                        stride=stride, padding=pad)


def _add_coords(x):
    """Append normalized (row, col) channels in [-1, 1]: the first varies
    along H, the second along W."""
    b, _, h, w = x.shape
    rows = torch.arange(h, dtype=x.dtype, device=x.device) / (h - 1) * 2 - 1
    cols = torch.arange(w, dtype=x.dtype, device=x.device) / (w - 1) * 2 - 1
    rows = rows[None, None, :, None].expand(b, 1, h, w)
    cols = cols[None, None, None, :].expand(b, 1, h, w)
    return torch.cat([x, rows, cols], dim=1)


def _res_block(x, p, coord_conv=True):
    h = _add_coords(x) if coord_conv else x
    h = F.leaky_relu(_conv(h, p["conv1"], pad=1), 0.2)
    h = _add_coords(h) if coord_conv else h
    h = F.leaky_relu(_conv(h, p["conv2"], stride=2, pad=1), 0.2)
    skip = _conv(x, p["proj"], stride=2)
    return (h + skip) / math.sqrt(2.0)


def apply_discriminator(params: Params, cfg: DiscriminatorConfig,
                        images: torch.Tensor, alpha=1.0):
    """(B, C, H, W) images in [-1, 1] -> (score (B, 1), latent_geo,
    latent_app, position); latents and pose are None for score-only
    configs. The input resolution selects the entry block."""
    size = images.shape[-1]
    start = 8 - int(math.log2(size))
    if not 0 <= start <= 7:
        raise ValueError(f"unsupported discriminator input size {size}")
    h = F.leaky_relu(_conv(images, params["from_rgb"][start]), 0.2)
    for i, bi in enumerate(range(start, _N_BLOCKS)):
        if i == 1:
            # fade-in with the next adapter on the 2x nearest-downsampled
            # input; exact identity at alpha = 1
            down = images[:, :, ::2, ::2]
            skip = F.leaky_relu(_conv(down, params["from_rgb"][start + 1]),
                                0.2)
            h = alpha * h + (1.0 - alpha) * skip
        h = _res_block(h, params["blocks"][bi], cfg.coord_conv)
    out = _conv(h, params["final"]).reshape(images.shape[0], -1)
    if not (cfg.latent_geo_dim or cfg.latent_app_dim):
        return out[:, :1], None, None, None
    g, a = cfg.latent_geo_dim, cfg.latent_app_dim
    return (out[:, 0:1], out[:, 1:1 + g],
            out[:, 1 + g:1 + g + a] if a else None,
            out[:, 1 + g + a:1 + g + a + 2])
