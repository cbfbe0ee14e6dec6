"""LPIPS perceptual distance (VGG16 backbone) in PyTorch, weights-gated (the
port of fenerf_tpu/eval/lpips.py).

The reference inversion uses lpips.PerceptualLoss('net-lin', 'vgg')
(inverse_render_double_semantic.py:175). The weights are read from the
same .npz as the JAX package's, named by $FENERF_LPIPS_WEIGHTS: VGG16 conv
kernels in HWIO (turned to OIHW here) and biases, and the five linear heads
as (1, 1, C, 1). The .npz is written once from the lpips distribution by
convert_torch_lpips below (the JAX package's converter writes the same
file).
With no weights present, load_lpips() returns None and the caller decides
whether the perceptual term may be dropped.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from fenerf_tpu_torch.utils.precision import exact_convs

# VGG16 conv plan: (out_channels, n_convs) per stage; LPIPS taps the output
# of each stage's last ReLU
_VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

WEIGHTS_ENV = "FENERF_LPIPS_WEIGHTS"


def torch_params(arrays: dict, device="cpu") -> dict:
    """The .npz arrays as tensors: conv kernels HWIO -> OIHW, the linear
    heads (1, 1, C, 1) -> (1, C, 1, 1), biases as they are."""
    out = {}
    for k, v in arrays.items():
        t = torch.as_tensor(np.asarray(v, np.float32), device=device)
        if t.ndim == 4:
            t = t.permute(3, 2, 0, 1).contiguous()
        out[k] = t
    return out


def _vgg_features(params, x):
    """x: (B, 3, H, W) in [-1, 1] -> list of 5 stage features (NCHW)."""
    shift = torch.as_tensor(_SHIFT, device=x.device)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=x.device)[None, :, None, None]
    h = (x - shift) / scale
    feats = []
    idx = 0
    for si, (_, n_convs) in enumerate(_VGG_STAGES):
        for _ in range(n_convs):
            h = F.relu(F.conv2d(h, params[f"conv{idx}_w"],
                                params[f"conv{idx}_b"], padding=1))
            idx += 1
        feats.append(h)
        if si < len(_VGG_STAGES) - 1:
            h = F.max_pool2d(h, 2, 2)
    return feats


def lpips_distance(params, x, y):
    """Perceptual distance between (B, 3, H, W) images in [-1, 1], summed
    over the batch (as the JAX function)."""
    with exact_convs(deterministic=False):
        fx = _vgg_features(params, x)
        fy = _vgg_features(params, y)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a / torch.clamp(torch.linalg.vector_norm(
                a, dim=1, keepdim=True), min=1e-10)
            b = b / torch.clamp(torch.linalg.vector_norm(
                b, dim=1, keepdim=True), min=1e-10)
            d = F.conv2d((a - b) ** 2, params[f"lin{i}_w"])
            total = total + d.mean(dim=(1, 2, 3)).sum()
    return total


def load_lpips(path: str | None = None, device="cuda"):
    """-> callable(x, y) on `device`, or None if no weights are available."""
    path = path or os.environ.get(WEIGHTS_ENV)
    if not path or not os.path.exists(path):
        return None
    with np.load(path) as data:
        params = torch_params({k: data[k] for k in data.files}, device)

    def fn(x, y):
        return lpips_distance(params, x, y)

    return fn


def convert_torch_lpips(lpips_module, out_path: str) -> None:
    """One-time converter: a torch lpips.LPIPS(net='vgg') module -> the
    .npz load_lpips reads (run wherever the lpips package and its weights
    exist): conv{i}_w HWIO and conv{i}_b in the VGG's layer order,
    lin{i}_w (1, 1, C, 1)."""
    sd = lpips_module.state_dict()
    arr = lambda t: t.detach().cpu().numpy()
    arrays = {}
    conv_keys = [k for k in sd
                 if k.startswith("net.slice") and k.endswith(".weight")]
    conv_keys.sort(key=lambda k: int(k.split(".")[2]))
    for i, k in enumerate(conv_keys):
        arrays[f"conv{i}_w"] = arr(sd[k]).transpose(2, 3, 1, 0)
        arrays[f"conv{i}_b"] = arr(sd[k.replace("weight", "bias")])
    for i in range(5):
        w = arr(sd[f"lins.{i}.model.1.weight"])   # (1, C, 1, 1)
        arrays[f"lin{i}_w"] = w.transpose(2, 3, 1, 0)
    np.savez(out_path, **arrays)
