"""InceptionV3 (pytorch-fid's variant) as a pool3 feature extractor in
inference mode (port of fenerf_tpu/nn/inception.py).

The FID protocol (fid_evaluation.py / eval_metrics.py) scores with
pytorch-fid's InceptionV3: torchvision's InceptionV3 with the FID tweaks
(the branch-pool average pools with count_include_pad=False, the second
InceptionE block max-pools its pool branch). Features are the 2048-d
global average of the last mixed block (pool3).

BatchNorm is folded into (scale, shift). The parameter tree and its `.npz`
layout are the JAX package's: "<block>/<branch>/w" in HWIO, "scale",
"shift", so one $FENERF_INCEPTION_WEIGHTS file serves both packages.
`inception_from_torch` maps a pytorch-fid state dict; `init_inception`
makes stand-in weights from a torch.Generator (shape and pipeline tests
only, not a valid FID scorer).

Convolutions run with TF32 off (F4) through utils/precision.exact_convs.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from fenerf_tpu_torch.utils.precision import exact_convs, exact_matmuls

Params = Any

# ---------------------------------------------------------------------------
# primitives (NCHW)
# ---------------------------------------------------------------------------


def _conv_bn(p, x, stride=1, pad=(0, 0)):
    y = F.conv2d(x, p["w"].permute(3, 2, 0, 1), stride=stride, padding=pad)
    y = y * p["scale"][None, :, None, None] + p["shift"][None, :, None, None]
    return torch.relu(y)


def _max_pool(x, k=3, s=2, pad=0):
    return F.max_pool2d(x, k, s, pad)


def _avg_pool_nocount(x, k=3, s=1, pad=1):
    """avg_pool 3x3 with count_include_pad=False (the FID tweak)."""
    return F.avg_pool2d(x, k, s, pad, count_include_pad=False)


# ---------------------------------------------------------------------------
# blocks (torchvision InceptionV3 structure)
# ---------------------------------------------------------------------------

def _inception_a(p, x):
    b1 = _conv_bn(p["branch1x1"], x)
    b5 = _conv_bn(p["branch5x5_1"], x)
    b5 = _conv_bn(p["branch5x5_2"], b5, pad=(2, 2))
    b3 = _conv_bn(p["branch3x3dbl_1"], x)
    b3 = _conv_bn(p["branch3x3dbl_2"], b3, pad=(1, 1))
    b3 = _conv_bn(p["branch3x3dbl_3"], b3, pad=(1, 1))
    bp = _conv_bn(p["branch_pool"], _avg_pool_nocount(x))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _inception_b(p, x):
    b3 = _conv_bn(p["branch3x3"], x, stride=2)
    bd = _conv_bn(p["branch3x3dbl_1"], x)
    bd = _conv_bn(p["branch3x3dbl_2"], bd, pad=(1, 1))
    bd = _conv_bn(p["branch3x3dbl_3"], bd, stride=2)
    return torch.cat([b3, bd, _max_pool(x)], dim=1)


def _inception_c(p, x):
    b1 = _conv_bn(p["branch1x1"], x)
    b7 = _conv_bn(p["branch7x7_1"], x)
    b7 = _conv_bn(p["branch7x7_2"], b7, pad=(0, 3))
    b7 = _conv_bn(p["branch7x7_3"], b7, pad=(3, 0))
    bd = _conv_bn(p["branch7x7dbl_1"], x)
    bd = _conv_bn(p["branch7x7dbl_2"], bd, pad=(3, 0))
    bd = _conv_bn(p["branch7x7dbl_3"], bd, pad=(0, 3))
    bd = _conv_bn(p["branch7x7dbl_4"], bd, pad=(3, 0))
    bd = _conv_bn(p["branch7x7dbl_5"], bd, pad=(0, 3))
    bp = _conv_bn(p["branch_pool"], _avg_pool_nocount(x))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _inception_d(p, x):
    b3 = _conv_bn(p["branch3x3_1"], x)
    b3 = _conv_bn(p["branch3x3_2"], b3, stride=2)
    b7 = _conv_bn(p["branch7x7x3_1"], x)
    b7 = _conv_bn(p["branch7x7x3_2"], b7, pad=(0, 3))
    b7 = _conv_bn(p["branch7x7x3_3"], b7, pad=(3, 0))
    b7 = _conv_bn(p["branch7x7x3_4"], b7, stride=2)
    return torch.cat([b3, b7, _max_pool(x)], dim=1)


def _inception_e(p, x, pool: str):
    b1 = _conv_bn(p["branch1x1"], x)
    b3 = _conv_bn(p["branch3x3_1"], x)
    b3 = torch.cat([_conv_bn(p["branch3x3_2a"], b3, pad=(0, 1)),
                    _conv_bn(p["branch3x3_2b"], b3, pad=(1, 0))], dim=1)
    bd = _conv_bn(p["branch3x3dbl_1"], x)
    bd = _conv_bn(p["branch3x3dbl_2"], bd, pad=(1, 1))
    bd = torch.cat([_conv_bn(p["branch3x3dbl_3a"], bd, pad=(0, 1)),
                    _conv_bn(p["branch3x3dbl_3b"], bd, pad=(1, 0))], dim=1)
    if pool == "max":  # FIDInceptionE_2
        bp = _max_pool(x, k=3, s=1, pad=1)
    else:
        bp = _avg_pool_nocount(x)
    bp = _conv_bn(p["branch_pool"], bp)
    return torch.cat([b1, b3, bd, bp], dim=1)


BLOCKS = [
    ("Mixed_5b", "a"), ("Mixed_5c", "a"), ("Mixed_5d", "a"),
    ("Mixed_6a", "b"),
    ("Mixed_6b", "c"), ("Mixed_6c", "c"), ("Mixed_6d", "c"), ("Mixed_6e", "c"),
    ("Mixed_7a", "d"),
    ("Mixed_7b", "e_avg"), ("Mixed_7c", "e_max"),
]


def apply_block(p, kind: str, x):
    """One mixed block of kind 'a' .. 'd', 'e_avg' or 'e_max'."""
    if kind == "a":
        return _inception_a(p, x)
    if kind == "b":
        return _inception_b(p, x)
    if kind == "c":
        return _inception_c(p, x)
    if kind == "d":
        return _inception_d(p, x)
    return _inception_e(p, x, "max" if kind == "e_max" else "avg")


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) weights of jax.image.resize's 'bilinear' along one
    axis: a triangle kernel at half-pixel centres, widened by the scale
    when downsampling (antialiasing), normalized over the input samples
    (so the border taps renormalize instead of clamping)."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    f32 = np.float32
    sample = ((np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv)
              - f32(0.5))
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / f32(kscale)
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(f32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = np.where(inside[None, :], w, 0).astype(f32)
    return torch.from_numpy(np.ascontiguousarray(w.T)).to(device)


def resize_bilinear(images: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, size, size, C) as jax.image.resize(...,
    'bilinear') computes it, in both directions (F.interpolate without
    antialiasing agrees only when upsampling)."""
    b, h, w, c = images.shape
    wh = _resize_weights(h, size, images.device)
    ww = _resize_weights(w, size, images.device)
    with exact_matmuls():   # F4
        x = torch.einsum("oh,bhwc->bowc", wh, images)
        return torch.einsum("pw,bowc->bopc", ww, x)


def inception_pool3(params: Params, images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, 3) float in [0, 1] -> pool3 features (B, 2048).

    pytorch-fid's preprocessing: bilinear resize to 299 (as jax.image),
    scale to [-1, 1]."""
    with exact_convs():
        x = resize_bilinear(images.float(), 299)
        x = (x * 2.0 - 1.0).permute(0, 3, 1, 2)  # NCHW in [-1, 1]
        x = _conv_bn(params["Conv2d_1a_3x3"], x, stride=2)
        x = _conv_bn(params["Conv2d_2a_3x3"], x)
        x = _conv_bn(params["Conv2d_2b_3x3"], x, pad=(1, 1))
        x = _max_pool(x)
        x = _conv_bn(params["Conv2d_3b_1x1"], x)
        x = _conv_bn(params["Conv2d_4a_3x3"], x)
        x = _max_pool(x)
        for name, kind in BLOCKS:
            x = apply_block(params[name], kind, x)
        return x.mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _fold(sd: Mapping, prefix: str, eps: float = 1e-3) -> dict:
    """torchvision BasicConv2d: conv (no bias) + BN(eps=0.001), folded."""
    w = _np(sd[f"{prefix}.conv.weight"])
    mean = _np(sd[f"{prefix}.bn.running_mean"])
    var = _np(sd[f"{prefix}.bn.running_var"])
    gamma = _np(sd[f"{prefix}.bn.weight"])
    beta = _np(sd[f"{prefix}.bn.bias"])
    scale = gamma / np.sqrt(var + eps)
    return {"w": torch.from_numpy(np.ascontiguousarray(
                w.transpose(2, 3, 1, 0))),
            "scale": torch.from_numpy(scale),
            "shift": torch.from_numpy(beta - mean * scale)}


_BRANCHES = {
    "a": ["branch1x1", "branch5x5_1", "branch5x5_2", "branch3x3dbl_1",
          "branch3x3dbl_2", "branch3x3dbl_3", "branch_pool"],
    "b": ["branch3x3", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"],
    "c": ["branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3",
          "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
          "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool"],
    "d": ["branch3x3_1", "branch3x3_2", "branch7x7x3_1", "branch7x7x3_2",
          "branch7x7x3_3", "branch7x7x3_4"],
    "e_avg": ["branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b",
              "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3a",
              "branch3x3dbl_3b", "branch_pool"],
}
_BRANCHES["e_max"] = _BRANCHES["e_avg"]
STEM = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1",
        "Conv2d_4a_3x3")


def inception_from_torch(sd: Mapping[str, Any]) -> Params:
    """pytorch-fid / torchvision inception_v3 state_dict -> param tree."""
    params: dict[str, Any] = {name: _fold(sd, name) for name in STEM}
    for name, kind in BLOCKS:
        params[name] = {br: _fold(sd, f"{name}.{br}")
                        for br in _BRANCHES[kind]}
    return params


def _flat(params: Params, prefix: str = "") -> dict:
    out = {}
    for k in sorted(params):
        v = params[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = _np(v).astype(np.float32)
    return out


def export_npz(sd_or_params: Mapping[str, Any], out_path: str) -> None:
    """Write the `.npz` for $FENERF_INCEPTION_WEIGHTS from a pytorch-fid
    state dict (mapped by inception_from_torch) or from a parameter tree
    of this module (e.g. init_inception's stand-ins)."""
    params = (inception_from_torch(sd_or_params)
              if "Conv2d_1a_3x3.conv.weight" in sd_or_params
              else sd_or_params)
    np.savez(out_path, **_flat(params))


def load_npz(path: str, device="cpu") -> Params:
    """The parameter tree of an `.npz` written by either package, as f32
    tensors on `device`."""
    params: dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            d = params
            for part in parts[:-1]:
                d = d.setdefault(part, {})
            d[parts[-1]] = torch.from_numpy(
                np.array(data[key], np.float32)).to(device)
    return params


# stand-in weights (shape / pipeline tests only, NOT a valid FID scorer)
_STEM_SPECS = [("Conv2d_1a_3x3", 3, 32, 3), ("Conv2d_2a_3x3", 32, 32, 3),
               ("Conv2d_2b_3x3", 32, 64, 3), ("Conv2d_3b_1x1", 64, 80, 1),
               ("Conv2d_4a_3x3", 80, 192, 3)]

BLOCK_CONVS = {
    # per block: branch -> (in, out, kh, kw)
    "Mixed_5b": {"branch1x1": (192, 64, 1, 1), "branch5x5_1": (192, 48, 1, 1),
                 "branch5x5_2": (48, 64, 5, 5),
                 "branch3x3dbl_1": (192, 64, 1, 1),
                 "branch3x3dbl_2": (64, 96, 3, 3),
                 "branch3x3dbl_3": (96, 96, 3, 3),
                 "branch_pool": (192, 32, 1, 1)},
    "Mixed_5c": {"branch1x1": (256, 64, 1, 1), "branch5x5_1": (256, 48, 1, 1),
                 "branch5x5_2": (48, 64, 5, 5),
                 "branch3x3dbl_1": (256, 64, 1, 1),
                 "branch3x3dbl_2": (64, 96, 3, 3),
                 "branch3x3dbl_3": (96, 96, 3, 3),
                 "branch_pool": (256, 64, 1, 1)},
    "Mixed_5d": {"branch1x1": (288, 64, 1, 1), "branch5x5_1": (288, 48, 1, 1),
                 "branch5x5_2": (48, 64, 5, 5),
                 "branch3x3dbl_1": (288, 64, 1, 1),
                 "branch3x3dbl_2": (64, 96, 3, 3),
                 "branch3x3dbl_3": (96, 96, 3, 3),
                 "branch_pool": (288, 64, 1, 1)},
    "Mixed_6a": {"branch3x3": (288, 384, 3, 3),
                 "branch3x3dbl_1": (288, 64, 1, 1),
                 "branch3x3dbl_2": (64, 96, 3, 3),
                 "branch3x3dbl_3": (96, 96, 3, 3)},
    "Mixed_7a": {"branch3x3_1": (768, 192, 1, 1),
                 "branch3x3_2": (192, 320, 3, 3),
                 "branch7x7x3_1": (768, 192, 1, 1),
                 "branch7x7x3_2": (192, 192, 1, 7),
                 "branch7x7x3_3": (192, 192, 7, 1),
                 "branch7x7x3_4": (192, 192, 3, 3)},
}
for _name, _c7 in [("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160),
                   ("Mixed_6e", 192)]:
    BLOCK_CONVS[_name] = {
        "branch1x1": (768, 192, 1, 1), "branch7x7_1": (768, _c7, 1, 1),
        "branch7x7_2": (_c7, _c7, 1, 7), "branch7x7_3": (_c7, 192, 7, 1),
        "branch7x7dbl_1": (768, _c7, 1, 1), "branch7x7dbl_2": (_c7, _c7, 7, 1),
        "branch7x7dbl_3": (_c7, _c7, 1, 7), "branch7x7dbl_4": (_c7, _c7, 7, 1),
        "branch7x7dbl_5": (_c7, 192, 1, 7), "branch_pool": (768, 192, 1, 1)}
for _name, _cin in [("Mixed_7b", 1280), ("Mixed_7c", 2048)]:
    BLOCK_CONVS[_name] = {
        "branch1x1": (_cin, 320, 1, 1), "branch3x3_1": (_cin, 384, 1, 1),
        "branch3x3_2a": (384, 384, 1, 3), "branch3x3_2b": (384, 384, 3, 1),
        "branch3x3dbl_1": (_cin, 448, 1, 1),
        "branch3x3dbl_2": (448, 384, 3, 3),
        "branch3x3dbl_3a": (384, 384, 1, 3),
        "branch3x3dbl_3b": (384, 384, 3, 1),
        "branch_pool": (_cin, 192, 1, 1)}


def init_inception(gen: torch.Generator, device="cpu") -> Params:
    """Stand-in parameters of the right shapes from `gen` (tests and
    pipeline checks only): N(0, 0.05^2) HWIO weights, unit scale, zero
    shift, as the JAX package's stand-ins."""
    def conv(cin, cout, kh, kw):
        return {"w": torch.randn((kh, kw, cin, cout), generator=gen,
                                 device=device) * 0.05,
                "scale": torch.ones((cout,), device=device),
                "shift": torch.zeros((cout,), device=device)}

    params: dict[str, Any] = {}
    for name, cin, cout, ksz in _STEM_SPECS:
        params[name] = conv(cin, cout, ksz, ksz)
    for name, _ in BLOCKS:
        params[name] = {br: conv(*spec)
                        for br, spec in BLOCK_CONVS[name].items()}
    return params

