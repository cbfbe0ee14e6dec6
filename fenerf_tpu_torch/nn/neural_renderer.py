"""The 2-D neural-renderer upsampler head of the HD path (port of
fenerf_tpu/nn/neural_renderer.py).

Reference: generators/neural_rendering.py (NeuralRenderer) — a
log2(img / input)-block conv pyramid that upsamples low-resolution NeRF
feature maps (64 / 128 channels) to RGB (+ seg) images, with per-level RGB
skip connections. StyleGenerator3d (generators/generators.py:914-1295)
uses it with the *HD SIREN variants, whose fields emit 64-channel
features (siren/siren.py:247-302, :1301-1366).

Parameters keep the JAX tree layout ({"w": HWIO, "b"} per conv), so a
checkpoint's heads copy across leaf for leaf; images are NCHW. The
convolutions run under utils/precision.exact_convs (cuDNN, TF32 off), as
the JAX package computes them with lax.conv. 'nearest' upsampling repeats
each pixel 2 x 2; 'bilinear' is half-pixel bilinear (jax.image.resize's,
which equals F.interpolate's when upsampling) followed by kornia's
filter2D blur ([1, 2, 1]^T [1, 2, 1] / 16, reflect border).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from fenerf_tpu_torch.nn import init as winit
from fenerf_tpu_torch.utils.precision import exact_convs

Params = Any


@dataclasses.dataclass(frozen=True)
class NeuralRendererConfig:
    """NeuralRenderer's constructor arguments (neural_rendering.py:37)."""
    n_feat: int = 128
    input_dim: int = 128
    out_dim: int = 3
    final_actvn: bool = True
    min_feat: int = 32
    img_size: int = 64
    input_size: int = 16
    use_rgb_skip: bool = True
    upsample_feat: str = "nn"        # 'nn' | 'bilinear' (+ blur)
    upsample_rgb: str = "bilinear"
    use_norm: bool = False

    @property
    def n_blocks(self) -> int:
        return int(math.log2(self.img_size) - math.log2(self.input_size))

    def feat_ch(self, i: int) -> int:
        """Output channels of conv block i (0-based)."""
        return max(self.n_feat // (2 ** (i + 1)), self.min_feat)


def init_neural_renderer(gen: torch.Generator, cfg: NeuralRendererConfig,
                         device="cpu") -> Params:
    """Random parameters in the JAX tree layout (torch's default conv
    init, drawn from `gen`; the draws differ from jax.random's)."""
    params: dict[str, Any] = {}
    if cfg.n_feat != cfg.input_dim:
        params["conv_in"] = winit.conv2d(gen, cfg.input_dim, cfg.n_feat, 1,
                                         device)
    convs = []
    cin = cfg.n_feat
    for i in range(cfg.n_blocks):
        convs.append(winit.conv2d(gen, cin, cfg.feat_ch(i), 3, device))
        cin = cfg.feat_ch(i)
    params["convs"] = convs
    if cfg.use_rgb_skip:
        params["rgbs"] = [winit.conv2d(gen, cfg.input_dim, cfg.out_dim, 3,
                                       device)] + [
            winit.conv2d(gen, cfg.feat_ch(i), cfg.out_dim, 3, device)
            for i in range(cfg.n_blocks)]
    else:
        params["rgb_out"] = winit.conv2d(
            gen, cfg.feat_ch(cfg.n_blocks - 1), 3, 1, device)
    return params


def _conv(x, p, pad):
    return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], padding=pad)


def _blur121(x):
    """kornia filter2D([1,2,1]^T [1,2,1], normalized=True): reflect border,
    depthwise 3x3 (neural_rendering.py:7-17)."""
    k = torch.tensor([1.0, 2.0, 1.0], dtype=x.dtype, device=x.device)
    k2 = (k[:, None] * k[None, :]) / 16.0
    c = x.shape[1]
    xp = F.pad(x, (1, 1, 1, 1), mode="reflect")
    return F.conv2d(xp, k2[None, None].expand(c, 1, 3, 3).contiguous(),
                    groups=c)


def _up_nearest(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def _up_bilinear_blur(x):
    y = F.interpolate(x, scale_factor=2, mode="bilinear",
                      align_corners=False)
    return _blur121(y)


def apply_neural_renderer(params: Params, cfg: NeuralRendererConfig,
                          x: torch.Tensor) -> torch.Tensor:
    """(B, input_dim, H, W) feature maps -> (B, out_dim, H*2^n, W*2^n)
    (NeuralRenderer.forward, neural_rendering.py:96-120), f32."""
    up_feat = _up_nearest if cfg.upsample_feat == "nn" else _up_bilinear_blur
    up_rgb = _up_nearest if cfg.upsample_rgb == "nn" else _up_bilinear_blur
    x = x.float()
    with exact_convs():
        net = _conv(x, params["conv_in"], 0) if "conv_in" in params else x
        rgb = None
        if cfg.use_rgb_skip:
            rgb = up_rgb(_conv(x, params["rgbs"][0], 1))
        for idx, lyr in enumerate(params["convs"]):
            hid = _conv(up_feat(net), lyr, 1)
            if cfg.use_norm:
                mean = hid.mean(dim=(2, 3), keepdim=True)
                var = ((hid - mean) ** 2).mean(dim=(2, 3), keepdim=True)
                hid = (hid - mean) * torch.rsqrt(var + 1e-5)
            net = F.leaky_relu(hid, 0.2)
            if cfg.use_rgb_skip:
                rgb = rgb + _conv(net, params["rgbs"][idx + 1], 1)
                if idx < len(params["convs"]) - 1:
                    rgb = up_rgb(rgb)
        if not cfg.use_rgb_skip:
            rgb = _conv(net, params["rgb_out"], 0)
    if cfg.final_actvn:
        rgb = torch.sigmoid(rgb)
    return rgb


def config_from_torch_module(tm) -> NeuralRendererConfig:
    """A NeuralRendererConfig from an unpickled reference NeuralRenderer
    module (released generator pickles embed these as
    .neural_renderer_img / _seg). img_size / input_size are stored only as
    their ratio (n_blocks): the absolute values are free."""
    convs = list(tm.conv_layers)
    n_blocks = len(convs)
    use_rgb_skip = bool(tm.use_rgb_skip)
    out_dim = (tm.conv_rgb[0].out_channels if use_rgb_skip
               else tm.conv_rgb.out_channels)
    return NeuralRendererConfig(
        n_feat=convs[0].in_channels,
        input_dim=int(tm.input_dim),
        out_dim=int(out_dim),
        final_actvn=bool(tm.final_actvn),
        min_feat=convs[-1].out_channels,
        img_size=16 * 2 ** n_blocks,
        input_size=16,
        use_rgb_skip=use_rgb_skip,
        # bilinear upsamplers are Sequential(Upsample, Blur); nn is a bare
        # Upsample (no submodules)
        upsample_feat="bilinear" if list(tm.upsample_2.children()) else "nn",
        upsample_rgb="bilinear" if list(tm.upsample_rgb.children()) else "nn",
        use_norm=bool(tm.use_norm),
    )


def neural_renderer_from_torch(sd, cfg: NeuralRendererConfig,
                               device="cpu") -> Params:
    """A reference NeuralRenderer's state_dict -> its parameter tree
    (float32 on `device`; HWIO convs, a layout translation only)."""
    def t(x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        return x.detach().to(device=device, dtype=torch.float32)

    def conv(prefix):
        return {"w": t(sd[f"{prefix}.weight"]).permute(2, 3, 1, 0)
                .contiguous(), "b": t(sd[f"{prefix}.bias"])}

    params: dict[str, Any] = {}
    if "conv_in.weight" in sd:
        params["conv_in"] = conv("conv_in")
    params["convs"] = [conv(f"conv_layers.{i}") for i in range(cfg.n_blocks)]
    if cfg.use_rgb_skip:
        params["rgbs"] = [conv(f"conv_rgb.{i}")
                          for i in range(cfg.n_blocks + 1)]
    else:
        params["rgb_out"] = conv("conv_rgb")
    return params
