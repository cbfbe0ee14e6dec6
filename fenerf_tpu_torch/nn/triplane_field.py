"""EG3D's tri-plane generator (Chan et al., "Efficient Geometry-aware 3D
Generative Adversarial Networks", CVPR 2022; NVlabs/eg3d
training/triplane.py::TriPlaneGenerator, training/superresolution.py::
SuperresolutionHybrid8XDC), the port's third field family.

  mapping     z (512) and the camera label c (25: cam2world's 16 values,
              the normalised intrinsics' 9) -> w (512)
              (nn/stylegan.py::conditioned_mapping)
  backbone    a StyleGAN2 skip synthesis network 4 -> 256 at
              min(32768 / res, 512) channels, 96 output channels read as
              three 32-channel 256 x 256 planes (nn/stylegan.py)
  field       per point: its coordinates x 2 / box_warp projected onto the
              three planes as (x, y), (x, z) and (z, x) (the inverse of
              EG3D's generate_planes axes, the third plane's swap kept as
              published), each plane sampled bilinearly (zeros outside,
              align_corners off), the mean over the planes, then OSGDecoder:
              FC 32 -> 64, softplus, FC 64 -> 33; density output 0, the 32
              features sigmoid(x) * 1.002 - 0.001
  superres    two synthesis blocks on the 128 x 128 feature image: 32 ->
              256 channels at 256 x 256, 256 -> 128 at 512 x 512, each
              ToRGB to 3 channels, the RGB skip starting from the feature
              image's first 3 channels; no noise

Parameters keep the port's layouts (linears (in, out), convolutions HWIO);
`params_from_eg3d` maps a TriPlaneGenerator state_dict onto them. The
rendering around the field (EG3D's camera, its importance renderer and
MipRayMarcher2) is models/generator.py::render_eg3d.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from fenerf_tpu_torch.nn import stylegan
from fenerf_tpu_torch.utils.profiling import span
from fenerf_tpu_torch.utils.precision import exact_matmuls

Params = Any
MODELS = ("TriPlaneGenerator",)


@dataclasses.dataclass(frozen=True)
class TriPlaneConfig:
    """EG3D's ffhq512-128 generator at its published widths."""
    name: str = "TriPlaneGenerator"
    z_dim: int = 512
    c_dim: int = 25
    w_dim: int = 512
    map_depth: int = 2
    plane_res: int = 256
    plane_ch: int = 32
    channel_base: int = 32768
    channel_max: int = 512
    decoder_hidden: int = 64
    decoder_lr_mul: float = 1.0
    box_warp: float = 1.0
    sr_in: int = 128                 # the neural rendering resolution
    sr_channels: tuple = (256, 128)  # block0 at 2 sr_in, block1 at 4 sr_in

    @property
    def output_dim(self) -> int:
        """What the field gives per point: the plane_ch features, then the
        density (the port's renderers read the last channel as sigma)."""
        return self.plane_ch + 1

    @property
    def img_size(self) -> int:
        return self.sr_in * 2 ** len(self.sr_channels)


def is_triplane_model(model: str) -> bool:
    return model in MODELS


def get_triplane_config(model: str = "TriPlaneGenerator",
                        **overrides) -> TriPlaneConfig:
    if not is_triplane_model(model):
        raise ValueError(f"{model!r} is not a tri-plane model")
    if "sr_channels" in overrides:
        overrides["sr_channels"] = tuple(overrides["sr_channels"])
    return TriPlaneConfig(name=model, **overrides)


def init_triplane_generator(gen: torch.Generator, cfg: TriPlaneConfig,
                            device="cpu") -> Params:
    """Random parameters, EG3D's initialisations (noise strengths 0)."""
    sr, in_ch = [], cfg.plane_ch
    for i, ch in enumerate(cfg.sr_channels):
        sr.append(stylegan.init_synthesis_block(
            gen, in_ch, ch, cfg.w_dim, cfg.sr_in * 2 ** (i + 1), 3, device))
        in_ch = ch
    return {
        "mapping": stylegan.init_conditioned_mapping(
            gen, cfg.z_dim, cfg.c_dim, cfg.w_dim, cfg.map_depth, device),
        "backbone": stylegan.init_synthesis_network(
            gen, cfg.w_dim, cfg.plane_res, 3 * cfg.plane_ch,
            cfg.channel_base, cfg.channel_max, device),
        "decoder": {"fc0": stylegan.init_equal_linear(
                        gen, cfg.plane_ch, cfg.decoder_hidden, device,
                        lr_mul=cfg.decoder_lr_mul),
                    "fc1": stylegan.init_equal_linear(
                        gen, cfg.decoder_hidden, 1 + cfg.plane_ch, device,
                        lr_mul=cfg.decoder_lr_mul)},
        "superres": sr,
    }


# ---------------------------------------------------------------------------
# The four stages
# ---------------------------------------------------------------------------

def mapping(params: Params, z: torch.Tensor, c: torch.Tensor,
            psi: float = 1.0) -> torch.Tensor:
    with exact_matmuls():
        return stylegan.conditioned_mapping(params["mapping"], z, c, psi)


def planes(params: Params, cfg: TriPlaneConfig,
           w: torch.Tensor) -> torch.Tensor:
    """w (B, w_dim) -> (B, 3, plane_ch, plane_res, plane_res), the noise in
    mode 'const'."""
    with span("fenerf/eg3d/backbone", planes=3 * w.shape[0]), \
            exact_matmuls():
        img = stylegan.synthesis_network(params["backbone"], w)
    return img.reshape(w.shape[0], 3, cfg.plane_ch, *img.shape[-2:])


def project(points: torch.Tensor, box_warp: float = 1.0) -> torch.Tensor:
    """points (B, M, 3) -> grid coordinates (B, 3, M, 2) on the planes:
    (x, y), (x, z), (z, x) of the points x 2 / box_warp (EG3D's
    project_onto_planes with the inverse of generate_planes' axes)."""
    p = points * (2.0 / box_warp)
    x, y, z = p.unbind(-1)
    return torch.stack([torch.stack([x, y], -1), torch.stack([x, z], -1),
                        torch.stack([z, x], -1)], dim=1)


def sample_planes(pl: torch.Tensor, points: torch.Tensor,
                  box_warp: float = 1.0) -> torch.Tensor:
    """The planes (B, 3, C, H, W) at points (B, M, 3), bilinear with zeros
    outside, averaged over the planes -> (B, M, C)."""
    b, n, c, h, w = pl.shape
    m = points.shape[1]
    with span("fenerf/render/field/planes", rows=b * m):
        grid = project(points, box_warp).reshape(b * n, 1, m, 2)
        out = F.grid_sample(pl.reshape(b * n, c, h, w), grid, mode="bilinear",
                            padding_mode="zeros", align_corners=False)
        return out.reshape(b, n, c, m).mean(1).transpose(1, 2)


def decode(params: Params, cfg: TriPlaneConfig,
           feats: torch.Tensor) -> torch.Tensor:
    """OSGDecoder on (..., C) features -> (..., C + 1): the colour features
    sigmoid(x[1:]) * 1.002 - 0.001, then the raw density x[0]."""
    d, lr = params["decoder"], cfg.decoder_lr_mul
    with exact_matmuls():
        h = F.softplus(stylegan.equal_linear(d["fc0"], feats, lr_mul=lr))
        x = stylegan.equal_linear(d["fc1"], h, lr_mul=lr)
    rgb = torch.sigmoid(x[..., 1:]) * (1 + 2 * 0.001) - 0.001
    return torch.cat([rgb, x[..., :1]], dim=-1)


def field_fn(params: Params, cfg: TriPlaneConfig, pl: torch.Tensor):
    """The per-point field of models/generator.py's ray blocks: points,
    dirs (B, M, 3) -> (B, M, plane_ch + 1). EG3D's decoder reads no view
    direction."""
    def fn(pts, drs):
        return decode(params, cfg, sample_planes(pl, pts, cfg.box_warp))
    return fn


def superres(params: Params, cfg: TriPlaneConfig, rgb: torch.Tensor,
             feats: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SuperresolutionHybrid8XDC: the raw image rgb (B, 3, sr_in, sr_in) and
    the feature image (B, plane_ch, sr_in, sr_in) -> (B, 3, img_size,
    img_size)."""
    if feats.shape[-1] != cfg.sr_in:
        raise ValueError(f"the feature image is {feats.shape[-1]}^2; the "
                         f"super-resolution takes {cfg.sr_in}^2")
    with span("fenerf/eg3d/superres",
              pixels=w.shape[0] * cfg.img_size ** 2), exact_matmuls():
        x, img = feats, rgb
        for p in params["superres"]:
            x, img = stylegan.synthesis_block(p, x, img, w, noise_mode="none")
    return img


# ---------------------------------------------------------------------------
# EG3D's state_dict
# ---------------------------------------------------------------------------

def _fc(sd, key, device) -> Params:
    return {"w": sd[f"{key}.weight"].T.contiguous().to(device),
            "b": sd[f"{key}.bias"].to(device)}


def _conv(sd, key, device, noise: bool) -> Params:
    p = {"w": sd[f"{key}.weight"].permute(2, 3, 1, 0).contiguous().to(device),
         "b": sd[f"{key}.bias"].to(device),
         "mod": _fc(sd, f"{key}.affine", device)}
    if noise:
        p["noise_const"] = sd[f"{key}.noise_const"].to(device)
        p["noise_strength"] = sd[f"{key}.noise_strength"].reshape(()).to(
            device)
    return p


def _block(sd, key, device) -> Params:
    p = {}
    if f"{key}.const" in sd:
        p["const"] = sd[f"{key}.const"].to(device)
    else:
        p["conv0"] = _conv(sd, f"{key}.conv0", device, True)
    p["conv1"] = _conv(sd, f"{key}.conv1", device, True)
    p["torgb"] = _conv(sd, f"{key}.torgb", device, False)
    return p


def params_from_eg3d(sd: dict, cfg: TriPlaneConfig, device="cpu") -> Params:
    """A TriPlaneGenerator state_dict (EG3D's names and layouts: linears
    (out, in), convolutions OIHW) -> the port's parameter tree, float32 on
    `device`."""
    sd = {k: v.detach().float() for k, v in sd.items()}
    m = "backbone.mapping"
    res = list(stylegan.synthesis_channels(cfg.plane_res, cfg.channel_base,
                                           cfg.channel_max))
    return {
        "mapping": {"embed": _fc(sd, f"{m}.embed", device),
                    "fc": [_fc(sd, f"{m}.fc{i}", device)
                           for i in range(cfg.map_depth)],
                    "w_avg": sd[f"{m}.w_avg"].to(device)},
        "backbone": [_block(sd, f"backbone.synthesis.b{r}", device)
                     for r in res],
        "decoder": {"fc0": _fc(sd, "decoder.net.0", device),
                    "fc1": _fc(sd, "decoder.net.2", device)},
        "superres": [_block(sd, f"superresolution.block{i}", device)
                     for i in range(len(cfg.sr_channels))],
    }

