"""Plain latent-grid SIREN field: FENeRF's SPATIALSIRENGRID (siren.py,
"FENeRF w/ latent grid"), written from the published description in
float32.

  style_gen   StyleGAN2 generator of a 32 x 32 plane of 32-channel local
              latents from z (256): a mapping of 3 equalized linears
              (lr_mul 0.01, fused LeakyReLU), a 4 x 4 constant, modulated
              3 x 3 convolutions (demodulated; per-sample weights as grouped
              convolutions; 2x transposed-convolution upsampling with the
              [1, 3, 3, 1] blur) at 4, 8, 16 and 32, and a 1 x 1 modulated
              projection to 32 channels
  map         per point: the plane sampled bilinearly (align_corners off,
              zeros outside) at the box-warped (x, z), then 32 -> 256 -> 256
              with LeakyReLU(0.2), then 256 -> 9 * 2 * 256 frequencies and
              phases of the 8 trunk and 1 colour FiLM layers
  trunk       8 FiLM-SIREN layers on the point in its plane cell's local
              frame, box-warped; sigma_head 256 -> 1
  color       1 FiLM layer on [ray dir | trunk]; color_head 256 -> 3, sigmoid

Output per point: [rgb | sigma].
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.precision import EXACT, Products, matmul, round_to

FREQ_SCALE, FREQ_OFFSET, BOX_SIDE = 15.0, 30.0, 0.24
BLUR = (1.0, 3.0, 3.0, 1.0)


def _lrelu(x, bias=None):
    """StyleGAN2's fused LeakyReLU: (x + bias) -> LeakyReLU(0.2) * sqrt 2."""
    if bias is not None:
        x = x + bias.reshape((1, -1) + (1,) * (x.ndim - 2))
    return F.leaky_relu(x, 0.2) * math.sqrt(2.0)


def _conv(x, w, precision, **kw):
    return F.conv2d(round_to(x, precision), round_to(w, precision), **kw)


def _blur_kernel(gain, device):
    k = torch.tensor(BLUR, device=device)
    k = k[None, :] * k[:, None]
    return k / k.sum() * gain


def _blur(x, pad, gain):
    c = x.shape[1]
    k = _blur_kernel(gain, x.device).flip(0, 1)[None, None].repeat(c, 1, 1, 1)
    return F.conv2d(F.pad(x, (pad[0], pad[1], pad[0], pad[1])), k, groups=c)


def modulated_conv(p, x, w_lat, demodulate=True, upsample=False,
                   precision="float32"):
    """StyleGAN2's modulated convolution with per-sample weights."""
    kh, kw, cin, cout = p["w"].shape
    b = x.shape[0]
    style = matmul(w_lat, p["mod"]["w"] / math.sqrt(w_lat.shape[1]),
                   precision) + p["mod"]["b"]                   # (B, cin)
    weight = p["w"].permute(3, 2, 0, 1)[None] / math.sqrt(cin * kh * kw)
    weight = weight * style[:, None, :, None, None]             # (B,o,i,k,k)
    if demodulate:
        d = torch.rsqrt(weight.pow(2).sum((2, 3, 4)) + 1e-8)
        weight = weight * d[:, :, None, None, None]
    xg = x.reshape(1, b * cin, *x.shape[2:])
    if upsample:
        wt = weight.transpose(1, 2).reshape(b * cin, cout, kh, kw)
        out = F.conv_transpose2d(round_to(xg, precision),
                                 round_to(wt, precision), stride=2, groups=b)
        out = out.reshape(b, cout, *out.shape[2:])
        return _blur(out, (1, 1), 4.0)
    out = _conv(xg, weight.reshape(b * cout, cin, kh, kw), precision,
                padding=kh // 2, groups=b)
    return out.reshape(b, cout, *out.shape[2:])


def plane(params, z, precision="float32"):
    """z (B, 256) -> the latent plane (B, 32, 32, 32)."""
    p = params["style_gen"]
    w = z * torch.rsqrt((z * z).mean(-1, keepdim=True) + 1e-8)
    for lyr in p["mapping"]:
        w = _lrelu(matmul(w, lyr["w"] * (0.01 / math.sqrt(w.shape[1])),
                          precision), lyr["b"] * 0.01)
    b = z.shape[0]
    x = p["input"][None].expand(b, *p["input"].shape)
    x = _lrelu(modulated_conv(p["conv1"], x, w, precision=precision),
               p["conv1"]["b"])
    for i in range(0, len(p["convs"]), 2):
        up, same = p["convs"][i], p["convs"][i + 1]
        x = _lrelu(modulated_conv(up, x, w, upsample=True,
                                  precision=precision), up["b"])
        x = _lrelu(modulated_conv(same, x, w, precision=precision),
                   same["b"])
    out = modulated_conv(p["out_rgb"], x, w, demodulate=False,
                         precision=precision)
    return out + p["out_rgb"]["b"][None, :, None, None]


def local_latents(pl, warped):
    """The plane (B, C, H, W) sampled at the (x, z) of warped (B, N, 3)."""
    xz = warped[..., [0, 2]][:, :, None, :]                     # (B,N,1,2)
    out = F.grid_sample(pl, xz, mode="bilinear", padding_mode="zeros",
                        align_corners=False)                    # (B,C,N,1)
    return out[..., 0].permute(0, 2, 1)


def field(params, points, dirs, pl, prec: Products = EXACT, grid_res=32):
    """points, dirs (B, N, 3), the plane -> (B, N, 4)."""
    h = params["trunk"][1]["w"].shape[0]
    lat = local_latents(pl, points * (2.0 / BOX_SIDE))
    x = lat
    for lyr in params["map"][:-1]:
        x = F.leaky_relu(matmul(x, lyr["w"], prec.mapping) + lyr["b"], 0.2)
    last = params["map"][-1]
    half = last["w"].shape[1] // 2

    def film_sin(t, lyr, li):
        f = slice(li * h, (li + 1) * h)
        ph = slice(half + li * h, half + (li + 1) * h)
        freq = (matmul(x, last["w"][:, f], prec.mapping) + last["b"][f]) \
            * FREQ_SCALE + FREQ_OFFSET
        phase = matmul(x, last["w"][:, ph], prec.mapping) + last["b"][ph]
        return torch.sin(freq * (matmul(t, lyr["w"], prec.field) + lyr["b"])
                         + phase)

    c = (points + 1.0) / 2.0 * grid_res
    c = (c - torch.round(c - 0.5)) * 2.0 - 1.0
    t = c * (2.0 / BOX_SIDE)
    for li, lyr in enumerate(params["trunk"]):
        t = film_sin(t, lyr, li)
    sigma = matmul(t, params["sigma_head"]["w"], prec.heads) \
        + params["sigma_head"]["b"]
    col = film_sin(torch.cat([dirs, t], -1), params["color"][0],
                   len(params["trunk"]))
    rgb = torch.sigmoid(matmul(col, params["color_head"]["w"], prec.heads)
                        + params["color_head"]["b"])
    return torch.cat([rgb, sigma], -1)
