"""Plain FiLM-SIREN field with a 3-D texture grid: FENeRF's
TextureEmbeddingPiGAN256SEMANTICDISENTANGLE_DIM_96 (siren.py), written from
the published description in float32.

Parameters are the benchmark's trees (linear weights (in, out)):
  geo_map / app_map  5 linears each, LeakyReLU(0.2) between: z (256) ->
                     frequencies and phases of the 8 trunk / 3 colour
                     FiLM layers (2 * L * 256)
  trunk              8 FiLM-SIREN layers, 3 -> 256 -> ... -> 256
  sigma_head         256 -> 1
  label_head         256 -> 256 -> 256 -> 18, no activation between
  color              3 FiLM layers: [ray dir | texture (32) | trunk] -> 256
  color_head         256 -> 3, sigmoid
  grid               (32, 96, 96, 96) texture, sampled trilinearly
                     (align_corners, zeros outside) at the box-warped point

A FiLM layer is sin(freq * (x @ w + b) + phase) with freq = 15 f + 30.
Output per point: [18 labels | rgb | sigma].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.precision import EXACT, Products, matmul, round_to

FREQ_SCALE, FREQ_OFFSET, BOX_SIDE = 15.0, 30.0, 0.24


def mapping(layers, z, precision: str = "float32"):
    """z -> (frequencies, phases), each (B, L * hidden)."""
    x = z
    for lyr in layers[:-1]:
        x = F.leaky_relu(matmul(x, lyr["w"], precision) + lyr["b"], 0.2)
    x = matmul(x, layers[-1]["w"], precision) + layers[-1]["b"]
    half = x.shape[-1] // 2
    return x[..., :half], x[..., half:]


def film(params, z_geo, z_app, prec: Products = EXACT):
    """W-space film activations ((fg, pg), (fa, pa)) of the latents."""
    return (mapping(params["geo_map"], z_geo, prec.mapping),
            mapping(params["app_map"], z_app, prec.mapping))


def truncate(film_, avg, psi):
    return tuple((af + psi * (f - af), ap + psi * (p - ap))
                 for (f, p), (af, ap) in zip(film_, avg))


def texture(grid, coords):
    """Trilinear samples of grid (C, D, H, W) at coords (B, N, 3) in
    [-1, 1], (x, y, z) indexing (W, H, D) -> (B, N, C)."""
    b, n, _ = coords.shape
    out = F.grid_sample(grid[None], coords.reshape(1, b * n, 1, 1, 3),
                        mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out.reshape(grid.shape[0], b, n).permute(1, 2, 0)


def field(params, points, dirs, film_geo, film_app,
          prec: Products = EXACT):
    """points, dirs (B, N, 3) -> (B, N, n_labels + 3 + 1)."""
    h = params["trunk"][1]["w"].shape[0]
    fg, pg = film_geo
    fa, pa = film_app
    fg = fg * FREQ_SCALE + FREQ_OFFSET
    fa = fa * FREQ_SCALE + FREQ_OFFSET
    chunk = lambda t, i: t[:, None, i * h:(i + 1) * h]

    def film_sin(x, lyr, freq, phase):
        return torch.sin(freq * (matmul(x, lyr["w"], prec.field) + lyr["b"])
                         + phase)

    x_in = points * (2.0 / BOX_SIDE)
    tex = round_to(texture(params["grid"], x_in), prec.table)
    x = x_in
    for i, lyr in enumerate(params["trunk"]):
        x = film_sin(x, lyr, chunk(fg, i), chunk(pg, i))
    lin = lambda t, lyr: matmul(t, lyr["w"], prec.heads) + lyr["b"]
    sigma = lin(x, params["sigma_head"])
    labels = x
    for lyr in params["label_head"]:
        labels = lin(labels, lyr)
    c = torch.cat([dirs, tex, x], -1)
    for i, lyr in enumerate(params["color"]):
        c = film_sin(c, lyr, chunk(fa, i), chunk(pa, i))
    rgb = torch.sigmoid(lin(c, params["color_head"]))
    return torch.cat([labels, rgb, sigma], -1)


def avg_film(params, gen: torch.Generator, n: int = 10000,
             prec: Products = EXACT):
    """The mean W of n normal latents (truncation's centre)."""
    d = params["geo_map"][0]["w"].shape[0]
    dev = params["grid"].device
    zg = torch.randn((n, d), generator=gen, device=dev)
    za = torch.randn((n, d), generator=gen, device=dev)
    return tuple((f.mean(0, keepdim=True), p.mean(0, keepdim=True))
                 for f, p in film(params, zg, za, prec))
