"""BiSeNet face parsing in inference mode (port of
fenerf_tpu/nn/bisenet.py).

Reference: generators/BiSeNet.py + generators/resnet.py — a ResNet18
backbone, the context path with attention refinement (ARM), the res8
features standing in for the spatial path, the feature fusion module
(FFM), a 1x1 head -> per-pixel class logits, and a bilinear
align_corners=True resize back to the input size. apps/prepare_segmaps.py
uses it to label face photos with CelebA-style parsing maps.

BatchNorm is folded into per-channel (scale, shift) at load time from the
running statistics, in float32 numpy as the JAX package folds it. The
convolutions are NCHW F.conv2d under utils/precision.exact_convs (cuDNN,
TF32 off), as the JAX package computes them with lax.conv. The
align-corners resizes are two separable interpolation matrices, float32
weights from float64 source positions, applied as a pair of products with
TF32 off. Weights come from the reference's segNet-20Class.pth
(`load_bisenet`), which is not in the repository; `stand_in_state_dict`
makes seeded weights in its layout for tests and smoke runs.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from fenerf_tpu_torch.utils.precision import exact_convs, exact_matmuls

Params = Any

# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def _conv(x, w, stride=1, pad=0):
    return F.conv2d(x, w, stride=stride, padding=pad)


def _conv_bn_relu(p, x, stride=1, pad=1, relu=True):
    y = _conv(x, p["w"], stride, pad)
    y = y * p["scale"][None, :, None, None] + p["shift"][None, :, None, None]
    return torch.relu(y) if relu else y


def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear align_corners=True interpolation weights."""
    if n_in == 1:
        return np.ones((n_out, 1), np.float32)
    src = np.arange(n_out) * (n_in - 1) / max(n_out - 1, 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    t = (src - lo).astype(np.float32)
    w = np.zeros((n_out, n_in), np.float32)
    w[np.arange(n_out), lo] += 1 - t
    w[np.arange(n_out), hi] += t
    return w


def resize_bilinear_ac(x: torch.Tensor, out_hw: tuple[int, int]
                       ) -> torch.Tensor:
    """(B, C, H, W) bilinear resize with align_corners=True: the rows'
    matrix, then the columns', f32 products with TF32 off."""
    h, w = x.shape[2], x.shape[3]
    wr = torch.from_numpy(_interp_matrix(h, out_hw[0])).to(x.device)
    wc = torch.from_numpy(_interp_matrix(w, out_hw[1])).to(x.device)
    with exact_matmuls():   # F4
        y = torch.einsum("oh,bchw->bcow", wr, x)
        return torch.einsum("bcow,pw->bcop", y, wc)


def _global_avg(x):
    return x.mean(dim=(2, 3), keepdim=True)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _basic_block(p, x, stride):
    y = _conv_bn_relu(p["conv1"], x, stride=stride, pad=1)
    y = _conv_bn_relu(p["conv2"], y, pad=1, relu=False)
    skip = x
    if "downsample" in p:
        skip = _conv_bn_relu(p["downsample"], x, stride=stride, pad=0,
                             relu=False)
    return torch.relu(y + skip)


def _resnet18(p, x):
    y = _conv_bn_relu(p["stem"], x, stride=2, pad=3)
    y = F.max_pool2d(y, 3, 2, 1)   # pads with -inf, as the JAX package
    feats = []
    for li, stride in enumerate((1, 2, 2, 2)):
        for bi in range(2):
            y = _basic_block(p[f"layer{li + 1}"][bi], y,
                             stride if bi == 0 else 1)
        if li >= 1:
            feats.append(y)  # feat8 (128ch), feat16 (256ch), feat32 (512ch)
    return feats


def _arm(p, x):
    feat = _conv_bn_relu(p["conv"], x, pad=1)
    atten = _conv(_global_avg(feat), p["atten_w"])
    atten = atten * p["atten_scale"][None, :, None, None] \
        + p["atten_shift"][None, :, None, None]
    return feat * torch.sigmoid(atten)


def _ffm(p, fsp, fcp):
    feat = _conv_bn_relu(p["convblk"], torch.cat([fsp, fcp], dim=1), pad=0)
    atten = torch.relu(_conv(_global_avg(feat), p["conv1_w"]))
    atten = torch.sigmoid(_conv(atten, p["conv2_w"]))
    return feat * atten + feat


def _head(p, x):
    return _conv(_conv_bn_relu(p["conv"], x, pad=1), p["out_w"])


def bisenet_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) normalized image -> (B, n_classes, H, W) logits
    (reference BiSeNet.forward :239-251)."""
    h, w = x.shape[2], x.shape[3]
    with exact_convs():
        feat8, feat16, feat32 = _resnet18(params["resnet"], x)
        avg = _conv_bn_relu(params["conv_avg"], _global_avg(feat32), pad=0)
        f32 = _arm(params["arm32"], feat32) + avg   # (B, 128, 1, 1) spread
        f32_up = resize_bilinear_ac(f32, (feat16.shape[2], feat16.shape[3]))
        f32_up = _conv_bn_relu(params["conv_head32"], f32_up, pad=1)
        f16 = _arm(params["arm16"], feat16) + f32_up
        f16_up = resize_bilinear_ac(f16, (feat8.shape[2], feat8.shape[3]))
        f16_up = _conv_bn_relu(params["conv_head16"], f16_up, pad=1)
        out = _head(params["conv_out"], _ffm(params["ffm"], feat8, f16_up))
        return resize_bilinear_ac(out, (h, w))


# ---------------------------------------------------------------------------
# weights: the reference's state_dict
# ---------------------------------------------------------------------------

def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _fold_bn(sd: Mapping, conv_key: str, bn_key: str, eps=1e-5) -> dict:
    """A conv's OIHW weight and its BatchNorm folded to (scale, shift)."""
    w = _np(sd[f"{conv_key}.weight"])
    mean = _np(sd[f"{bn_key}.running_mean"])
    var = _np(sd[f"{bn_key}.running_var"])
    g = _np(sd[f"{bn_key}.weight"])
    b = _np(sd[f"{bn_key}.bias"])
    scale = g / np.sqrt(var + eps)
    return {"w": w, "scale": scale, "shift": b - mean * scale}


def bisenet_from_torch(sd: Mapping[str, Any], device="cpu") -> Params:
    """A reference BiSeNet state_dict (segNet-20Class.pth) -> the
    inference parameter tree on `device`."""
    def block(prefix):
        p = {"conv1": _fold_bn(sd, f"{prefix}.conv1", f"{prefix}.bn1"),
             "conv2": _fold_bn(sd, f"{prefix}.conv2", f"{prefix}.bn2")}
        if f"{prefix}.downsample.0.weight" in sd:
            p["downsample"] = _fold_bn(sd, f"{prefix}.downsample.0",
                                       f"{prefix}.downsample.1")
        return p

    resnet = {"stem": _fold_bn(sd, "cp.resnet.conv1", "cp.resnet.bn1")}
    for li in range(1, 5):
        resnet[f"layer{li}"] = [block(f"cp.resnet.layer{li}.{bi}")
                                for bi in range(2)]

    def arm(prefix):
        atten = _fold_bn(sd, f"{prefix}.conv_atten", f"{prefix}.bn_atten")
        return {"conv": _fold_bn(sd, f"{prefix}.conv.conv",
                                 f"{prefix}.conv.bn"),
                "atten_w": atten["w"], "atten_scale": atten["scale"],
                "atten_shift": atten["shift"]}

    params = {
        "resnet": resnet,
        "arm16": arm("cp.arm16"),
        "arm32": arm("cp.arm32"),
        "conv_head32": _fold_bn(sd, "cp.conv_head32.conv",
                                "cp.conv_head32.bn"),
        "conv_head16": _fold_bn(sd, "cp.conv_head16.conv",
                                "cp.conv_head16.bn"),
        "conv_avg": _fold_bn(sd, "cp.conv_avg.conv", "cp.conv_avg.bn"),
        "ffm": {"convblk": _fold_bn(sd, "ffm.convblk.conv", "ffm.convblk.bn"),
                "conv1_w": _np(sd["ffm.conv1.weight"]),
                "conv2_w": _np(sd["ffm.conv2.weight"])},
        "conv_out": {"conv": _fold_bn(sd, "conv_out.conv.conv",
                                      "conv_out.conv.bn"),
                     "out_w": _np(sd["conv_out.conv_out.weight"])},
    }
    dev = torch.device(device)

    def to(p):
        if isinstance(p, dict):
            return {k: to(v) for k, v in p.items()}
        if isinstance(p, list):
            return [to(v) for v in p]
        return torch.from_numpy(np.ascontiguousarray(p, np.float32)).to(dev)

    return to(params)


def load_bisenet(path: str, device="cuda") -> Params:
    """segNet-20Class.pth (a torch state_dict, or a module holding one) ->
    the parameter tree on `device`."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to "
                           "parse on the CPU")
    sd = torch.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return bisenet_from_torch(sd, dev)


def _conv_bn_keys(out: dict, g, conv: str, bn: str, cin: int, cout: int,
                  k: int) -> None:
    fan_in = cin * k * k
    out[f"{conv}.weight"] = torch.randn(cout, cin, k, k, generator=g) \
        * (2.0 / fan_in) ** 0.5
    out[f"{bn}.weight"] = 0.5 + torch.rand(cout, generator=g)
    out[f"{bn}.bias"] = 0.1 * torch.randn(cout, generator=g)
    out[f"{bn}.running_mean"] = 0.1 * torch.randn(cout, generator=g)
    out[f"{bn}.running_var"] = 0.5 + 1.5 * torch.rand(cout, generator=g)
    out[f"{bn}.num_batches_tracked"] = torch.tensor(0)


def _conv_keys(out: dict, g, key: str, cin: int, cout: int) -> None:
    out[f"{key}.weight"] = torch.randn(cout, cin, 1, 1, generator=g) \
        * (1.0 / cin) ** 0.5


def stand_in_state_dict(seed: int = 0, n_classes: int = 20) -> dict:
    """Seeded weights in segNet-20Class.pth's layout (every key of the
    reference's BiSeNet(n_classes), the auxiliary 16 / 32 heads the
    inference path skips included), BatchNorm running statistics away from
    (0, 1) so that folding them matters. Tests and smoke runs only: not a
    face parser."""
    g = torch.Generator().manual_seed(seed)
    sd: dict = {}
    _conv_bn_keys(sd, g, "cp.resnet.conv1", "cp.resnet.bn1", 3, 64, 7)
    cin = 64
    for li, cout in enumerate((64, 128, 256, 512), start=1):
        for bi in range(2):
            p = f"cp.resnet.layer{li}.{bi}"
            _conv_bn_keys(sd, g, f"{p}.conv1", f"{p}.bn1", cin, cout, 3)
            _conv_bn_keys(sd, g, f"{p}.conv2", f"{p}.bn2", cout, cout, 3)
            if bi == 0 and li > 1:   # stride 2, wider
                _conv_bn_keys(sd, g, f"{p}.downsample.0",
                              f"{p}.downsample.1", cin, cout, 1)
            cin = cout
    for name, c in (("arm16", 256), ("arm32", 512)):
        _conv_bn_keys(sd, g, f"cp.{name}.conv.conv", f"cp.{name}.conv.bn",
                      c, 128, 3)
        _conv_bn_keys(sd, g, f"cp.{name}.conv_atten", f"cp.{name}.bn_atten",
                      128, 128, 1)
    for name in ("conv_head32", "conv_head16"):
        _conv_bn_keys(sd, g, f"cp.{name}.conv", f"cp.{name}.bn", 128, 128, 3)
    _conv_bn_keys(sd, g, "cp.conv_avg.conv", "cp.conv_avg.bn", 512, 128, 1)
    _conv_bn_keys(sd, g, "ffm.convblk.conv", "ffm.convblk.bn", 256, 256, 1)
    _conv_keys(sd, g, "ffm.conv1", 256, 64)
    _conv_keys(sd, g, "ffm.conv2", 64, 256)
    for name, cin, mid in (("conv_out", 256, 256), ("conv_out16", 128, 64),
                           ("conv_out32", 128, 64)):
        _conv_bn_keys(sd, g, f"{name}.conv.conv", f"{name}.conv.bn", cin,
                      mid, 3)
        _conv_keys(sd, g, f"{name}.conv_out", mid, n_classes)
    return sd


# the 20-class parsing -> the CelebAMask-HQ 19 classes (prepare_segmaps.py:12)
REMAP_FFHQ_TO_CELEBA = (0, 1, 6, 7, 4, 5, 2, 2, 10, 11, 12, 8, 9, 15, 3,
                        17, 16, 18, 13, 14)


def remap_labels(mask: np.ndarray,
                 table=REMAP_FFHQ_TO_CELEBA) -> np.ndarray:
    return np.asarray(table, dtype=np.uint8)[np.asarray(mask)]
