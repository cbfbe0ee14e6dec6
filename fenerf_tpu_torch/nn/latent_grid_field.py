"""Latent-grid SIREN field, the "FENeRF w/ latent grid" model family (port
of fenerf_tpu/nn/latent_grid_field.py).

A StyleGAN2-style 2-D generator (nn/stylegan.py) turns z into a plane of
local latent codes over the (x, z) ground plane (32 x 32 x 32 channels at
the published size). Each 3-D sample bilinearly samples its local latent,
which drives a small per-point mapping network (3 linears) -> per-POINT
FiLM frequencies and phases for the 8-layer trunk and the colour layer.
Point coordinates are remapped into per-cell local frames before the box
warp the field applies a second time, as the JAX package (and the
reference) does.

Precision: the mapping network's products and the heads are f32 (TF32 off,
torch's default for matmuls; ROADMAP F4); the FiLM layers' products take
compute_dtype-rounded operands with f32 accumulation (fields._dot, T1).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from fenerf_tpu_torch.core.grid_sample import grid_sample_2d
from fenerf_tpu_torch.nn import init as winit
from fenerf_tpu_torch.nn import stylegan
from fenerf_tpu_torch.nn.fields import _dot, _init_mapping
from fenerf_tpu_torch.ops.fast_math import fast_sin

Params = Any


@dataclasses.dataclass(frozen=True)
class GridFieldConfig:
    name: str = "SPATIALSIRENGRID"
    z_dim: int = 256
    hidden_dim: int = 256
    trunk_layers: int = 8
    grid_res: int = 32
    grid_ch: int = 32
    ch_max: int = 256
    map_hidden_dim: int = 256
    local_coordinates: bool = True
    box_side: float = 0.24
    rgb_dim: int = 3
    freq_scale: float = 15.0
    freq_offset: float = 30.0

    @property
    def output_dim(self) -> int:
        return self.rgb_dim + 1

    # the film family's names, so that family-generic code (apps) reads
    # both configs alike: the grid family has one latent and no labels
    @property
    def n_labels(self) -> int:
        return 0

    @property
    def z_geo_dim(self) -> int:
        return self.z_dim

    @property
    def z_app_dim(self) -> int:
        return self.z_dim


GRID_VARIANTS: dict[str, GridFieldConfig] = {
    "SPATIALSIRENGRID": GridFieldConfig(),
}


def is_grid_model(name: str) -> bool:
    return name in GRID_VARIANTS


def get_grid_config(name: str, **overrides) -> GridFieldConfig:
    cfg = GRID_VARIANTS[name]
    # film-family keywords that shared call sites may pass
    overrides.pop("n_labels", None)
    zg = overrides.pop("z_geo_dim", None)
    overrides.pop("z_app_dim", None)
    if zg and "z_dim" not in overrides:
        overrides["z_dim"] = zg
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def init_grid_field(gen: torch.Generator, cfg: GridFieldConfig,
                    device="cpu") -> Params:
    """Random parameters in the JAX package's tree layout, drawn from `gen`
    (the draws differ from jax.random's; the distributions match). On the
    meta device: the tree's structure and shapes, no memory."""
    h = cfg.hidden_dim

    def freq(g, i, o, dev):
        return winit.frequency_weight(g, i, o, dev, 25.0)

    trunk = [winit.linear(gen, 3 if li == 0 else h, h,
                          winit.first_layer_film_weight if li == 0 else freq,
                          device)
             for li in range(cfg.trunk_layers)]
    n_film = cfg.trunk_layers + 1
    return {
        "style_gen": stylegan.init_style_generator_2d(
            gen, out_res=cfg.grid_res, out_ch=cfg.grid_ch, z_dim=cfg.z_dim,
            ch_max=cfg.ch_max, skip_conn=False, device=device),
        "map": _init_mapping(gen, cfg.grid_ch, cfg.map_hidden_dim,
                             n_film * h * 2, device, n_blocks=1),
        "trunk": trunk,
        "sigma_head": winit.linear(gen, h, 1, freq, device),
        "color": [winit.linear(gen, h + 3, h, freq, device)],
        "color_head": winit.linear(gen, h, cfg.rgb_dim, freq, device),
    }


def local_coordinates(global_coords: torch.Tensor,
                      grid_length: int) -> torch.Tensor:
    """Map [-1, 1] coordinates into per-cell [-1, 1] frames. torch.round
    rounds half to even, as jnp.round (T2)."""
    c = (global_coords + 1.0) / 2.0 * grid_length
    c = c - torch.round(c - 0.5)
    return c * 2.0 - 1.0


def sample_local_latents(grid: torch.Tensor,
                         warped_xyz: torch.Tensor) -> torch.Tensor:
    """grid (B, C, H, W); warped_xyz (B, N, 3) -> (B, N, C): bilinear at the
    (x, z) ground-plane coordinates."""
    xz = warped_xyz[..., [0, 2]]
    return torch.stack([grid_sample_2d(g, c) for g, c in zip(grid, xz)])


def compute_plane(params: Params, cfg: GridFieldConfig,
                  z: torch.Tensor) -> torch.Tensor:
    """The StyleGenerator2D latent plane (B, C, H, W) for z (B, z_dim):
    per-render work, passed to apply_grid_field(plane=...) so that the
    convolutions do not run again for every ray block."""
    return stylegan.style_generator_2d(params["style_gen"], z)


def apply_grid_field(params: Params, cfg: GridFieldConfig,
                     points: torch.Tensor, ray_dirs: torch.Tensor,
                     z: torch.Tensor, compute_dtype=torch.float32,
                     plane: torch.Tensor | None = None) -> torch.Tensor:
    """points, ray_dirs (B, N, 3) -> (B, N, 4) [rgb, sigma]."""
    h = cfg.hidden_dim
    grid = plane if plane is not None else compute_plane(params, cfg, z)
    latents = sample_local_latents(grid, points * (2.0 / cfg.box_side))

    # the per-point mapping network (3 linears, LeakyReLU between); its last
    # linear gives each FiLM layer's frequencies and phases, formed one
    # layer at a time: no (B, N, 9 * 2 * h) tensor (1.8 GB at a 4096-ray
    # block of 24 samples)
    x = latents
    for lyr in params["map"][:-1]:
        x = F.leaky_relu(x @ lyr["w"] + lyr["b"], 0.2)
    last = params["map"][-1]
    half = last["w"].shape[1] // 2

    coords = points
    if cfg.local_coordinates:
        coords = local_coordinates(points, cfg.grid_res)
    # the second box warp, inside the FiLM trunk as in the JAX package
    xx = coords * (2.0 / cfg.box_side)

    def film(xx, lyr, li):
        f = slice(li * h, (li + 1) * h)
        p = slice(half + li * h, half + (li + 1) * h)
        freqs = ((x @ last["w"][:, f] + last["b"][f]) * cfg.freq_scale
                 + cfg.freq_offset)
        phases = x @ last["w"][:, p] + last["b"][p]
        y = _dot(xx, lyr["w"], compute_dtype) + lyr["b"]
        return fast_sin(freqs * y + phases)

    for li, lyr in enumerate(params["trunk"]):
        xx = film(xx, lyr, li)

    sigma = xx @ params["sigma_head"]["w"] + params["sigma_head"]["b"]
    c = torch.cat([ray_dirs, xx], dim=-1)
    c = film(c, params["color"][0], cfg.trunk_layers)
    rgb = torch.sigmoid(c @ params["color_head"]["w"]
                        + params["color_head"]["b"])
    return torch.cat([rgb, sigma], dim=-1)

