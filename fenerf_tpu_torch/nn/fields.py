"""FiLM-SIREN neural fields (port of fenerf_tpu/nn/fields.py).

One generic field, configured per variant by FieldConfig; the VARIANTS
registry mirrors the JAX package's field by field. Parameters are nested
dicts / lists of tensors in the JAX layouts (Linear w is (in, out)), so a
JAX checkpoint copies in leaf for leaf (compat/jax_bridge.py).

apply_field has two routes:
  backend='torch'   the layer-by-layer path (the JAX package's XLA branch):
                    matmuls on compute_dtype-rounded operands with f32
                    accumulation, f32 FiLM epilogue with the polynomial sine.
  backend='kernel'  the fused field of ops/film_mlp.py: the hand-written
                    CUDA kernel on CUDA tensors, its plain torch version on
                    CPU tensors. Grid features come from a bf16 table.
  backend='kernel_train'  the same forward, differentiable through the
                    fused backward of ops/film_mlp_grad.py.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from fenerf_tpu_torch.core.grid_sample import (build_zexp_table,
                                               grid_sample_3d_fast,
                                               sample_zexp_table)
from fenerf_tpu_torch.nn import init as winit
from fenerf_tpu_torch.ops.fast_math import fast_sin

Params = Any  # nested dict / list of tensors


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    """Static architecture description of a FiLM-SIREN field."""
    name: str = "SIRENBASELINESEMANTICDISENTANGLE"
    hidden_dim: int = 256
    trunk_layers: int = 8
    color_layers: int = 3
    label_hidden_layers: int = 1     # hidden linears before the label output
    n_labels: int = 18               # 0 => RGB-only (pi-GAN baseline)
    rgb_dim: int = 3
    z_geo_dim: int = 256
    z_app_dim: int = 256
    map_hidden_dim: int = 256
    single_latent: bool = False      # one mapping net drives trunk + color
    grid_channels: int = 0           # 0 => no texture grid
    grid_resolution: int = 96
    grid_init_scale: float = 0.1
    grid_to: str = "color"           # 'color' | 'trunk'
    use_ray_dir: bool = True
    box_side: float = 0.24
    first_layer_init: str = "film"   # 'film' (1/fan_in) | 'modified' (1/3)
    label_sigmoid: bool = False
    rgb_sigmoid: bool = True
    label_film: bool = False         # FiLM-conditioned label head
    color_pre_dim: int = 0           # >0: Linear(h, d) replaces the trunk
                                     # output as the color input
    res_sigma: bool = False          # residual-coordinate sigma MLP
    freq_scale: float = 15.0
    freq_offset: float = 30.0
    sine_w0: float = 25.0            # frequency_init constant

    @property
    def output_dim(self) -> int:
        return self.n_labels + self.rgb_dim + 1

    @property
    def trunk_in_dim(self) -> int:
        d = 3
        if self.grid_channels and self.grid_to == "trunk":
            d += self.grid_channels
        return d

    @property
    def color_in_dim(self) -> int:
        if self.res_sigma:
            d = self.hidden_dim
        elif self.color_pre_dim:
            d = self.color_pre_dim
        else:
            d = self.hidden_dim
        if self.use_ray_dir:
            d += 3
        if self.grid_channels and self.grid_to == "color":
            d += self.grid_channels
        return d


_C = FieldConfig
VARIANTS: dict[str, FieldConfig] = {c.name: c for c in (
    _C(name="SIRENBASELINESEMANTICDISENTANGLE"),
    _C(name="TextureEmbeddingPiGAN256SEMANTICDISENTANGLE_DIM_96",
       label_hidden_layers=2, grid_channels=32, grid_resolution=96,
       grid_init_scale=0.1, first_layer_init="modified"),
    _C(name="TextureEmbeddingPiGAN256SEMANTICDISENTANGLE",
       label_hidden_layers=2, grid_channels=32, grid_resolution=64,
       grid_init_scale=0.1, first_layer_init="modified"),
    _C(name="TextureEmbeddingPiGAN128SEMANTICDISENTANGLE",
       hidden_dim=128, label_hidden_layers=2, grid_channels=32,
       grid_resolution=96, grid_init_scale=0.01, first_layer_init="modified"),
    _C(name="TextureEmbeddingPiGAN128SEMANTICDISENTANGLE_WO_DIR",
       hidden_dim=128, color_layers=8, label_hidden_layers=2,
       grid_channels=32, grid_resolution=96, grid_init_scale=0.01,
       first_layer_init="modified", use_ray_dir=False),
    _C(name="TextureEmbeddingPiGAN256SEMANTICDISENTANGLE_WO_DIR_DIM_96",
       color_layers=8, label_hidden_layers=2, grid_channels=32,
       grid_resolution=96, grid_init_scale=0.1,
       first_layer_init="modified", use_ray_dir=False),
    _C(name="EmbeddingPiGAN128SEMANTICDISENTANGLE",
       hidden_dim=128, label_hidden_layers=2, grid_channels=32,
       grid_resolution=96, grid_init_scale=0.01, grid_to="trunk",
       first_layer_init="modified"),
    _C(name="SPATIALSIRENSEMANTICDISENTANGLE", color_layers=8),
    _C(name="SPATIALSIRENDISENTANGLE", n_labels=0, color_layers=3,
       label_hidden_layers=0),
    _C(name="SPATIALSIRENBASELINESEMANTIC", n_labels=19, single_latent=True,
       color_layers=1, label_hidden_layers=1, z_geo_dim=256, z_app_dim=256),
    _C(name="SIRENBASELINESEMANTICDISENTANGLE_debug",
       n_labels=19, label_sigmoid=True),
    _C(name="SPATIALSIRENAUGDISENTANGLE", n_labels=0, color_layers=8,
       label_hidden_layers=0, color_pre_dim=3),
    _C(name="RESSIRENDISENTANGLE", n_labels=0, color_layers=6,
       label_hidden_layers=0, res_sigma=True),
    _C(name="SPATIALSIRENSEMANTIC", n_labels=19, single_latent=True,
       color_layers=1, label_hidden_layers=0, label_film=True,
       z_geo_dim=256, z_app_dim=256),
    _C(name="SPATIALSIRENBASELINEHD", n_labels=0, single_latent=True,
       color_layers=1, label_hidden_layers=0, rgb_dim=64, rgb_sigmoid=False,
       z_geo_dim=256, z_app_dim=256),
    _C(name="SPATIALSIRENSEMANTICHD", n_labels=64, single_latent=True,
       color_layers=1, label_hidden_layers=0, label_film=True,
       rgb_dim=64, rgb_sigmoid=False, z_geo_dim=256, z_app_dim=256),
    _C(name="EmbeddingPiGAN128", n_labels=0, single_latent=True,
       hidden_dim=128, color_layers=1, label_hidden_layers=0,
       grid_channels=32, grid_resolution=96, grid_init_scale=0.01,
       grid_to="trunk", first_layer_init="modified",
       z_geo_dim=256, z_app_dim=256),
    _C(name="EmbeddingPiGAN256", n_labels=0, single_latent=True,
       color_layers=1, label_hidden_layers=0,
       grid_channels=32, grid_resolution=64, grid_init_scale=0.1,
       grid_to="trunk", first_layer_init="modified",
       z_geo_dim=256, z_app_dim=256),
    _C(name="TALLSIREN", n_labels=0, single_latent=True, color_layers=1,
       label_hidden_layers=0, z_geo_dim=512, z_app_dim=512, box_side=0.0),
    _C(name="SPATIALSIRENBASELINE", n_labels=0, single_latent=True,
       color_layers=1, label_hidden_layers=0, z_geo_dim=512, z_app_dim=512),
)}


def get_config(name: str, **overrides) -> FieldConfig:
    cfg = VARIANTS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_mapping(gen, z_dim, hidden, out_dim, device, n_blocks=3):
    """Mapping network: 2+n_blocks linears, LeakyReLU(0.2) between,
    kaiming-leaky init, last weight x0.25."""
    dims = [(z_dim, hidden)] + [(hidden, hidden)] * n_blocks \
        + [(hidden, out_dim)]
    layers = [winit.linear(gen, i, o, winit.kaiming_leaky_weight, device)
              for i, o in dims]
    layers[-1]["w"] = layers[-1]["w"] * 0.25
    return layers


def init_field(gen: torch.Generator, cfg: FieldConfig,
               device="cpu") -> Params:
    """Random field parameters in the JAX package's tree layout, drawn from
    `gen` (the draws differ from jax.random's; the distributions match)."""
    h = cfg.hidden_dim

    def freq_init(g, i, o, dev):
        return winit.frequency_weight(g, i, o, dev, cfg.sine_w0)

    trunk = []
    for li in range(cfg.trunk_layers):
        fan_in = cfg.trunk_in_dim if li == 0 else h
        if li == 0 and cfg.first_layer_init == "modified":
            w_init = winit.modified_first_weight
        elif li == 0:
            w_init = winit.first_layer_film_weight
        else:
            w_init = freq_init
        trunk.append(winit.linear(gen, fan_in, h, w_init, device))

    color = []
    for li in range(cfg.color_layers):
        fan_in = cfg.color_in_dim if li == 0 else h
        w_init = freq_init
        if li == 0 and cfg.name == "SPATIALSIRENSEMANTICDISENTANGLE":
            w_init = winit.first_layer_film_weight
        color.append(winit.linear(gen, fan_in, h, w_init, device))

    params: dict[str, Params] = {
        "trunk": trunk,
        "color": color,
        "color_head": winit.linear(gen, h, cfg.rgb_dim, freq_init, device),
    }
    if cfg.res_sigma:
        params["res_coord"] = winit.linear(
            gen, h, 3, winit.torch_default_weight, device)
        params["sigma_mlp"] = [
            winit.linear(gen, 3, h, freq_init, device),
            winit.linear(gen, h, h, freq_init, device),
            winit.linear(gen, h, h, freq_init, device),
            winit.linear(gen, h, 1, freq_init, device),
        ]
        params["color_pre"] = winit.linear(
            gen, 3, h, winit.torch_default_weight, device)
    else:
        params["sigma_head"] = winit.linear(gen, h, 1, freq_init, device)
        if cfg.color_pre_dim:
            params["color_pre"] = winit.linear(
                gen, h, cfg.color_pre_dim, winit.torch_default_weight, device)
    if cfg.label_film:
        params["label_film"] = winit.linear(gen, h, h, freq_init, device)
    if cfg.n_labels:
        label = [winit.linear(gen, h, h, freq_init, device)
                 for _ in range(cfg.label_hidden_layers)]
        label.append(winit.linear(gen, h, cfg.n_labels, freq_init, device))
        params["label_head"] = label

    n_trunk_film = cfg.trunk_layers
    n_color_film = cfg.color_layers + int(cfg.label_film)
    if cfg.single_latent:
        out = (n_trunk_film + n_color_film) * h * 2
        params["geo_map"] = _init_mapping(
            gen, cfg.z_geo_dim, cfg.map_hidden_dim, out, device)
    else:
        params["geo_map"] = _init_mapping(
            gen, cfg.z_geo_dim, cfg.map_hidden_dim, n_trunk_film * h * 2,
            device)
        params["app_map"] = _init_mapping(
            gen, cfg.z_app_dim, cfg.map_hidden_dim, n_color_film * h * 2,
            device)
    if cfg.grid_channels:
        r = cfg.grid_resolution
        params["grid"] = winit.normal(
            gen, (cfg.grid_channels, r, r, r), device) * cfg.grid_init_scale
    return params


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def mapping_apply(layers, z: torch.Tensor):
    """z (B, z_dim) -> (freqs, phases), each (B, n_film * hidden)."""
    x = z
    for lyr in layers[:-1]:
        x = torch.nn.functional.leaky_relu(x @ lyr["w"] + lyr["b"], 0.2)
    x = x @ layers[-1]["w"] + layers[-1]["b"]
    half = x.shape[-1] // 2
    return x[..., :half], x[..., half:]


def field_film(params: Params, cfg: FieldConfig, z_geo, z_app):
    """Latents -> raw ((fg, pg), (fa, pa)) film activations (W space)."""
    if cfg.single_latent:
        f, p = mapping_apply(params["geo_map"], z_geo)
        cut = cfg.trunk_layers * cfg.hidden_dim
        return (f[..., :cut], p[..., :cut]), (f[..., cut:], p[..., cut:])
    fg, pg = mapping_apply(params["geo_map"], z_geo)
    fa, pa = mapping_apply(params["app_map"], z_app)
    return (fg, pg), (fa, pa)


def _dot(x: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """x @ w with both operands rounded to compute_dtype and f32
    accumulation (the JAX preferred_element_type=f32 contract: a bf16 torch
    matmul would round its result to bf16 as well)."""
    if compute_dtype == torch.float32:
        return x @ w
    return x.to(compute_dtype).float() @ w.to(compute_dtype).float()


def _film_sin(x, w, b, freq, phase, compute_dtype):
    """One FiLM layer: sin(freq * (x @ w + b) + phase), f32 epilogue."""
    return fast_sin(freq * (_dot(x, w, compute_dtype) + b) + phase)


GRID_TABLE_KEY = "grid_table"


def with_grid_table(params: Params, cfg, table_dtype=torch.bfloat16):
    """`params` plus the z-expanded texture table under GRID_TABLE_KEY (a
    derived tensor, never checkpointed). No-op for gridless configs or when
    a table is already present."""
    if (not isinstance(cfg, FieldConfig) or not cfg.grid_channels
            or GRID_TABLE_KEY in params):
        return params
    return {**params,
            GRID_TABLE_KEY: build_zexp_table(params["grid"], table_dtype)}


def _grid_feats(params: Params, warped: torch.Tensor, table_dtype):
    table = params.get(GRID_TABLE_KEY)
    if table is not None:
        return sample_zexp_table(table, params["grid"].shape, warped)
    return grid_sample_3d_fast(params["grid"], warped, table_dtype=table_dtype)


def apply_field(params: Params, cfg: FieldConfig, points: torch.Tensor,
                ray_dirs: torch.Tensor, film_geo, film_app,
                compute_dtype=torch.float32,
                backend: str = "torch") -> torch.Tensor:
    """Evaluate the field at points (B, N, 3) -> (B, N, n_labels + rgb + 1)."""
    if backend in ("kernel", "kernel_train"):
        from fenerf_tpu_torch.ops import film_mlp as film_mlp_ops

        warped = points * (2.0 / cfg.box_side) if cfg.box_side else points
        gf = None
        if cfg.grid_channels:
            # bf16 table: the kernel rounds the features to bf16 at its
            # first color matmul anyway; the gather stays differentiable,
            # so the features' cotangent reaches the table
            gf = _grid_feats(params, warped, torch.bfloat16)
        if backend == "kernel_train":
            from fenerf_tpu_torch.ops.film_mlp_grad import film_mlp_trainable

            return film_mlp_trainable(params, cfg, warped, ray_dirs, gf,
                                      film_geo, film_app)
        pack = film_mlp_ops.get_pack(params, cfg)
        return film_mlp_ops.film_mlp(pack, warped, ray_dirs, gf, film_geo,
                                     film_app)
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}")

    h = cfg.hidden_dim
    fg, pg = film_geo
    fa, pa = film_app
    fg = fg * cfg.freq_scale + cfg.freq_offset
    fa = fa * cfg.freq_scale + cfg.freq_offset

    def chunk(t, i):
        return t[..., None, i * h:(i + 1) * h]  # (B, 1, H) broadcast over N

    x_in = points * (2.0 / cfg.box_side) if cfg.box_side else points
    grid_feats = None
    if cfg.grid_channels:
        grid_feats = _grid_feats(
            params, x_in,
            torch.bfloat16 if compute_dtype == torch.bfloat16 else None)

    x = x_in
    if grid_feats is not None and cfg.grid_to == "trunk":
        x = torch.cat([grid_feats, x], dim=-1)
    for i, lyr in enumerate(params["trunk"]):
        x = _film_sin(x, lyr["w"], lyr["b"], chunk(fg, i), chunk(pg, i),
                      compute_dtype)

    color_src = x
    if cfg.res_sigma:
        coords = x_in + (x @ params["res_coord"]["w"]
                         + params["res_coord"]["b"])
        sigma = coords
        for lyr in params["sigma_mlp"]:   # stacked linears, no activations
            sigma = sigma @ lyr["w"] + lyr["b"]
        color_src = coords @ params["color_pre"]["w"] + params["color_pre"]["b"]
    else:
        sigma = x @ params["sigma_head"]["w"] + params["sigma_head"]["b"]
        if cfg.color_pre_dim:
            color_src = x @ params["color_pre"]["w"] + params["color_pre"]["b"]

    outs = []
    color_chunk0 = 0
    if cfg.n_labels:
        lbl = x
        if cfg.label_film:
            p = params["label_film"]
            lbl = _film_sin(lbl, p["w"], p["b"], chunk(fa, 0), chunk(pa, 0),
                            compute_dtype)
            color_chunk0 = 1
        for lyr in params["label_head"]:
            lbl = lbl @ lyr["w"] + lyr["b"]
        if cfg.label_sigmoid:
            lbl = torch.sigmoid(lbl)
        outs.append(lbl)

    c_parts = []
    if cfg.use_ray_dir:
        c_parts.append(ray_dirs)
    if grid_feats is not None and cfg.grid_to == "color":
        c_parts.append(grid_feats)
    c_parts.append(color_src)
    c = torch.cat(c_parts, dim=-1)
    for i, lyr in enumerate(params["color"]):
        c = _film_sin(c, lyr["w"], lyr["b"], chunk(fa, color_chunk0 + i),
                      chunk(pa, color_chunk0 + i), compute_dtype)
    rgb = c @ params["color_head"]["w"] + params["color_head"]["b"]
    if cfg.rgb_sigmoid:
        rgb = torch.sigmoid(rgb)
    outs.append(rgb)
    outs.append(sigma)
    return torch.cat(outs, dim=-1)


def avg_film(params: Params, cfg: FieldConfig, gen: torch.Generator,
             n: int = 10000):
    """Mean W-space point for truncation: n gaussian latents through the
    mapping nets, averaged."""
    device = params["geo_map"][0]["w"].device
    zg = torch.randn((n, cfg.z_geo_dim), generator=gen, device=device)
    za = torch.randn((n, cfg.z_app_dim), generator=gen, device=device)
    (fg, pg), (fa, pa) = field_film(params, cfg, zg, za)

    def mean(t):
        return t.mean(0, keepdim=True)

    return (mean(fg), mean(pg)), (mean(fa), mean(pa))


def truncate_film(film, avg, psi):
    """psi-truncation toward the average W; psi may be a float or a (B, 1)
    tensor (one psi per micro-batched request)."""
    (f, p), (af, ap) = film, avg
    return (af + psi * (f - af), ap + psi * (p - ap))
