"""Progressive-growing CoordConv residual discriminators (port of the CCS
double-encoder critics of fenerf_tpu/nn/discriminators.py that the trainer
uses), and the SPADE-style multiscale patch critics beside them.

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
from fenerf_tpu_torch.utils.precision import exact_convs, exact_matmuls

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


# ---------------------------------------------------------------------------
# SPADE-style patch discriminators (the reference's MultiscaleDiscriminator /
# NLayerDiscriminator; present beside the trainer's critics, not wired into
# it)
# ---------------------------------------------------------------------------

def init_nlayer_discriminator(gen: torch.Generator, input_nc=22, ndf=64,
                              n_layers=3, device="cpu") -> Params:
    """NLayerDiscriminator: 4x4 patchGAN convs; the middle layers use the
    reference default norm 'spectralinstance' (spectral-normalized conv +
    InstanceNorm2d without affine). Each layer holds its conv, its stride
    (int) and whether it is spectral-normalized (bool); those that are also
    hold the power iteration's `u`, drawn from `gen`."""
    layers = [{"conv": winit.conv2d(gen, input_nc, ndf, 4, device),
               "stride": 2, "sn": False}]
    nf = ndf
    for i in range(1, n_layers + 1):
        nf_prev, nf = nf, min(nf * 2, 512)
        layers.append({"conv": winit.conv2d(gen, nf_prev, nf, 4, device),
                       "stride": 2 if i < n_layers else 1, "sn": True,
                       "u": winit.normal(gen, (nf,), device)})
    layers.append({"conv": winit.conv2d(gen, nf, 1, 4, device),
                   "stride": 1, "sn": False})
    return {"layers": layers}


def _spectral_normalize(w, u, v=None, n_iters: int = 1):
    """Spectral normalization as torch's spectral_norm: in training, power
    iterations from u; in eval (v given) the stored u and v. -> (w / sigma,
    the updated u). u and v are held constant for the gradient."""
    c_out = w.shape[-1]
    # torch views the (out, in, kh, kw) weight as (out, -1); the HWIO
    # layout is permuted to that flattening order
    mat = w.permute(3, 2, 0, 1).reshape(c_out, -1)
    with torch.no_grad():
        if v is None:
            for _ in range(max(n_iters, 1)):
                v = mat.T @ u
                v = v / torch.clamp(torch.linalg.norm(v), min=1e-12)
                u = mat @ v
                u = u / torch.clamp(torch.linalg.norm(u), min=1e-12)
    u, v = u.detach(), v.detach()
    sigma = u @ (mat @ v)
    return w / sigma, u


def apply_nlayer_discriminator(params: Params, x: torch.Tensor,
                               get_interm: bool = False,
                               return_state: bool = False):
    """(B, C, H, W) -> patch logits (and every layer's features with
    get_interm). Spectral norm is stateful: with return_state=True the
    parameters with the updated `u` come back too, for the caller to carry
    into the next call; a layer with a stored `v` runs in eval mode."""
    h = x
    feats = []
    n = len(params["layers"])
    new_layers = []
    with exact_matmuls():
        for i, lyr in enumerate(params["layers"]):
            p = lyr["conv"]
            w = p["w"]
            if lyr["sn"]:
                w, u_new = _spectral_normalize(w, lyr["u"], lyr.get("v"))
                new_layers.append({**lyr, "u": u_new})
            else:
                new_layers.append(lyr)
            h = _conv(h, {"w": w, "b": p["b"]}, stride=lyr["stride"], pad=2)
            if lyr["sn"]:
                # InstanceNorm2d(affine=False): per-(sample, channel)
                mean = h.mean(dim=(2, 3), keepdim=True)
                var = ((h - mean) ** 2).mean(dim=(2, 3), keepdim=True)
                h = (h - mean) * torch.rsqrt(var + 1e-5)
            if i < n - 1:
                h = F.leaky_relu(h, 0.2)
            feats.append(h)
    out = feats if get_interm else feats[-1]
    if return_state:
        return out, {"layers": new_layers}
    return out


def init_multiscale_discriminator(gen: torch.Generator, input_nc=22, ndf=64,
                                  n_layers=3, num_d=3,
                                  device="cpu") -> Params:
    return {"scales": [init_nlayer_discriminator(gen, input_nc, ndf,
                                                 n_layers, device)
                       for _ in range(num_d)]}


def apply_multiscale_discriminator(params: Params, x: torch.Tensor,
                                   get_interm: bool = True,
                                   return_state: bool = False):
    """MultiscaleDiscriminator: each patchGAN on a progressively halved
    input (3x3 average, stride 2, padding 1, the padding not counted),
    the finest scale first. return_state=True also returns the parameters
    with each spectral norm's updated u."""
    results = []
    new_scales = []
    cur = x
    for i, sub in enumerate(params["scales"]):
        if return_state:
            r, new_sub = apply_nlayer_discriminator(sub, cur, get_interm,
                                                    return_state=True)
            new_scales.append(new_sub)
        else:
            r = apply_nlayer_discriminator(sub, cur, get_interm)
        results.append(r)
        if i != len(params["scales"]) - 1:
            cur = F.avg_pool2d(cur, 3, stride=2, padding=1,
                               count_include_pad=False)
    if return_state:
        return results, {"scales": new_scales}
    return results
