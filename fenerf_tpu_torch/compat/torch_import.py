"""Reference PyTorch state_dicts -> the port's parameter trees (port of
fenerf_tpu/compat/torch_import.py).

The reference saves whole-module pickles (torch.save(generator_ddp.module,
...)); loading those requires the reference package
(compat/reference_shim.py, apps/convert_checkpoint.py). These importers
instead consume a *state_dict* mapping (str -> tensor / ndarray).

Layout translation only, no arithmetic: torch's nn.Linear stores (out, in)
weights, the trees (in, out); Conv2d (out, in, kh, kw) becomes
(kh, kw, in, out). The output is trees of float32 tensors on `device` in
the JAX package's layout, bit-equal to its importers' arrays.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from fenerf_tpu_torch.nn.fields import FieldConfig


def _t(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.detach().to(device=device, dtype=torch.float32)


def _lin(sd: Mapping[str, Any], prefix: str, device) -> dict:
    return {"w": _t(sd[f"{prefix}.weight"], device).t().contiguous(),
            "b": _t(sd[f"{prefix}.bias"], device)}


def _hwio(w: torch.Tensor) -> torch.Tensor:
    """(out, in, kh, kw) -> (kh, kw, in, out)."""
    return w.permute(2, 3, 1, 0).contiguous()


def _conv(sd: Mapping[str, Any], prefix: str, device) -> dict:
    return {"w": _hwio(_t(sd[f"{prefix}.weight"], device)),
            "b": _t(sd[f"{prefix}.bias"], device)}


def strip_prefix(sd: Mapping[str, Any], prefix: str) -> dict:
    out = {}
    for k, v in sd.items():
        if k.startswith(prefix):
            out[k[len(prefix):]] = v
    return out


def field_from_torch(sd: Mapping[str, Any], cfg: FieldConfig,
                     device="cpu") -> dict:
    """A reference SIREN state_dict -> the field's parameter tree. Keys
    may carry a leading 'siren.' (generator pickles nest the field under
    .siren)."""
    if any(k.startswith("siren.") for k in sd):
        sd = strip_prefix(sd, "siren.")
    lin = lambda prefix: _lin(sd, prefix, device)

    params: dict[str, Any] = {
        "trunk": [lin(f"network.{i}.layer") for i in range(cfg.trunk_layers)],
        "color_head": lin("color_layer_linear.0"),
    }

    if cfg.res_sigma:
        # RESSIRENDISENTANGLE
        params["res_coord"] = lin("res_coord_layer")
        params["sigma_mlp"] = [lin(f"density_layer_linear.{i}")
                               for i in range(4)]
        params["color_pre"] = lin("color_layer_pre.0")
    else:
        params["sigma_head"] = lin("final_layer")
        if cfg.color_pre_dim:
            # SPATIALSIRENAUGDISENTANGLE
            params["color_pre"] = lin("color_layer_pre.0")

    # color branch: ModuleList of FiLM layers, or a single FiLMLayer in the
    # single-latent baselines (key color_layer_sine.layer.weight)
    if "color_layer_sine.layer.weight" in sd:
        params["color"] = [lin("color_layer_sine.layer")]
    else:
        params["color"] = [lin(f"color_layer_sine.{i}.layer")
                           for i in range(cfg.color_layers)]

    if cfg.n_labels:
        n = cfg.label_hidden_layers + 1
        params["label_head"] = [lin(f"label_layer_linear.{i}")
                                for i in range(n)]
        if cfg.label_film:
            params["label_film"] = lin("label_layer_sine.layer")

    def mapping(prefix):
        # reference Sequential indices 0,2,4,6,8 are the linears
        return [lin(f"{prefix}.network.{2 * j}") for j in range(5)]

    if cfg.single_latent:
        params["geo_map"] = mapping("mapping_network")
    else:
        params["geo_map"] = mapping("geo_mapping_network")
        params["app_map"] = mapping("app_mapping_network")

    if cfg.grid_channels:
        # (1, C, D, H, W) -> (C, D, H, W)
        params["grid"] = _t(sd["spatial_embeddings"], device)[0].contiguous()
    return params


# ------------------------------------------------------------------
# StyleGAN latent-grid import (StyleGenerator2D / SPATIALSIRENGRID)
# ------------------------------------------------------------------

def _mod_conv(sd: Mapping[str, Any], prefix: str, device) -> dict:
    """ModulatedConv2d: weight (1, out, in, kh, kw) -> (kh, kw, in, out);
    the activation's bias lives on .activate.bias, a plain bias on .bias
    (1, out, 1, 1), and a conv with neither gets zeros."""
    w = _t(sd[f"{prefix}.weight"], device)[0]   # (out, in, kh, kw)
    p = {"w": _hwio(w), "mod": _lin(sd, f"{prefix}.modulation", device)}
    if f"{prefix}.activate.bias" in sd:
        p["b"] = _t(sd[f"{prefix}.activate.bias"], device)
    elif f"{prefix}.bias" in sd:
        p["b"] = _t(sd[f"{prefix}.bias"], device).reshape(-1)
    else:
        p["b"] = torch.zeros((w.shape[0],), dtype=torch.float32,
                             device=device)
    return p


def style_generator_from_torch(sd: Mapping[str, Any], skip_conn: bool = False,
                               device="cpu") -> dict:
    """StyleGenerator2D -> the stylegan parameter tree."""
    params: dict[str, Any] = {
        "mapping": [_lin(sd, f"mapping_network.{i}", device)
                    for i in range(3)],
        "input": _t(sd["input.input"], device)[0].contiguous(),
        "conv1": _mod_conv(sd, "conv1", device),
    }
    convs = []
    i = 0
    while f"convs.{i}.weight" in sd:
        convs.append(_mod_conv(sd, f"convs.{i}", device))
        i += 1
    params["convs"] = convs
    if skip_conn:
        params["to_rgb1"] = _mod_conv(sd, "to_rgb1.conv", device)
        params["to_rgbs"] = []
        j = 0
        while f"to_rgbs.{j}.conv.weight" in sd:
            params["to_rgbs"].append(_mod_conv(sd, f"to_rgbs.{j}.conv",
                                               device))
            j += 1
    else:
        params["out_rgb"] = _mod_conv(sd, "out_rgb.conv", device)
    return params


def grid_field_from_torch(sd: Mapping[str, Any], trunk_layers: int = 8,
                          device="cpu") -> dict:
    """SPATIALSIRENGRID -> the latent-grid field's parameter tree."""
    if any(k.startswith("siren.") for k in sd):
        sd = strip_prefix(sd, "siren.")
    lin = lambda prefix: _lin(sd, prefix, device)
    return {
        "style_gen": style_generator_from_torch(
            strip_prefix(sd, "grid_latent_network."), device=device),
        "map": [lin(f"mapping_network.network.{2 * j}") for j in range(3)],
        "trunk": [lin(f"network.{i}.layer") for i in range(trunk_layers)],
        "sigma_head": lin("final_layer"),
        "color": [lin("color_layer_sine.layer")],
        "color_head": lin("color_layer_linear.0"),
    }


# ------------------------------------------------------------------
# Discriminator import (CCSDoubleEncoderDiscriminator and kin)
# ------------------------------------------------------------------

def discriminator_from_torch(sd: Mapping[str, Any], n_blocks: int = 7,
                             device="cpu") -> dict:
    """A reference CCS*Discriminator state_dict -> the critic's tree."""
    conv = lambda prefix: _conv(sd, prefix, device)
    blocks = []
    for i in range(n_blocks):
        # CoordConv blocks nest the conv under .conv; plain strided blocks
        # hold the Conv2d itself
        sub = ".conv" if f"layers.{i}.network.0.conv.weight" in sd else ""
        blocks.append({
            "conv1": conv(f"layers.{i}.network.0{sub}"),
            "conv2": conv(f"layers.{i}.network.2{sub}"),
            "proj": conv(f"layers.{i}.proj"),
        })
    from_rgb = []
    j = 0
    while f"fromRGB.{j}.model.0.weight" in sd:
        from_rgb.append(conv(f"fromRGB.{j}.model.0"))
        j += 1
    return {"blocks": blocks, "from_rgb": from_rgb,
            "final": conv("final_layer")}
