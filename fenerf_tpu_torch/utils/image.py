"""Image helpers of the serving path (the port's own copy of the numpy parts
of fenerf_tpu/utils/image.py): the 19-class CelebAMask-HQ palette,
label-map colouring, float-to-uint8 and the jet depth colouring.
"""
from __future__ import annotations

import numpy as np

# index 0 = background
CELEBA_PALETTE = np.array([
    [0, 0, 0], [204, 0, 0], [76, 153, 0], [204, 204, 0], [51, 51, 255],
    [204, 0, 204], [0, 255, 255], [255, 204, 204], [102, 51, 0], [255, 0, 0],
    [102, 204, 0], [255, 255, 0], [0, 0, 153], [0, 0, 204], [255, 51, 153],
    [0, 204, 204], [0, 51, 0], [255, 153, 51], [0, 204, 0],
], dtype=np.uint8)


def mask2color(labels: np.ndarray) -> np.ndarray:
    """(B, C, H, W) label logits / one-hot -> (B, H, W, 3) uint8 palette RGB
    of the argmax class."""
    idx = np.argmax(np.asarray(labels), axis=1)
    return CELEBA_PALETTE[idx % len(CELEBA_PALETTE)]


def to_uint8(img: np.ndarray, normalize: bool = True) -> np.ndarray:
    """(..., H, W) float in [-1, 1] (or min-max normalized) -> uint8."""
    img = np.asarray(img, dtype=np.float32)
    if normalize:
        lo, hi = img.min(), img.max()
        img = (img - lo) / max(hi - lo, 1e-8)
    else:
        img = (img + 1.0) / 2.0
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)


def depth_to_jet(depth: np.ndarray, lo=0.88, hi=1.12) -> np.ndarray:
    """Depth map -> jet colormap uint8 RGB (needs cv2)."""
    import cv2

    d = np.clip((np.asarray(depth) - lo) / max(hi - lo, 1e-8), 0, 1)
    return cv2.applyColorMap((d * 255).astype(np.uint8),
                             cv2.COLORMAP_JET)[..., ::-1]
