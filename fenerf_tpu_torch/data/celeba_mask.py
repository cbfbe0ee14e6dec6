"""The CelebAMask-HQ image geometry (the port's copy of
fenerf_tpu/data/celeba_mask.py::_prep) on numpy images, through the
PIL-exact resizes of utils/image.py, so no PIL is needed.

Reference transform (datasets.py:465-549): Resize(320) on the short side,
CenterCrop(256), Resize(img_size); masks take NEAREST through the same
geometry.
"""
from __future__ import annotations

import numpy as np

from fenerf_tpu_torch.utils.image import resize


def _prep(img: np.ndarray, img_size: int, nearest: bool) -> np.ndarray:
    """(H, W[, C]) uint8 -> (img_size, img_size[, C]) uint8: the short side
    scaled to 320 (round(w * scale), as Python rounds), the centre 256
    square, then img_size."""
    method = "nearest" if nearest else "bilinear"
    h, w = img.shape[:2]
    scale = 320 / min(w, h)
    img = resize(img, (round(w * scale), round(h * scale)), method)
    h, w = img.shape[:2]
    left, top = (w - 256) // 2, (h - 256) // 2
    img = img[top:top + 256, left:left + 256]
    return resize(img, (img_size, img_size), method)
