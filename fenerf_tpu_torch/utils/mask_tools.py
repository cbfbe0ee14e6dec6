"""Segmentation-mask edits for the editing workflow (port of
fenerf_tpu/utils/mask_tools.py).

Reference: tools.py — semantic remove / switch / scale edits and mask
simplification feed hand-edited masks back into GAN inversion
(rm_semantic :463, switch_semantic :499, scale_semantic :551,
gen_face_simplifed_mask :86). apps/edit_mask.py scripts them and
apps/paint_ui.py serves them to a browser.

numpy and scipy only. The JAX package grows and shrinks a class with
cv2.dilate / cv2.erode (3x3 ones, `iterations` times); here the same
morphology is a box maximum / minimum of side 2 * iterations + 1, which is
what cv2 computes for a rectangular kernel: its default border value never
lets the outside of the image grow a region or erode it.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage

from fenerf_tpu_torch.utils.image import CELEBA_PALETTE

# CelebAMask-HQ 19-class ids
LABELS = {
    "background": 0, "skin": 1, "nose": 2, "eye_glasses": 3, "left_eye": 4,
    "right_eye": 5, "left_brow": 6, "right_brow": 7, "left_ear": 8,
    "right_ear": 9, "mouth": 10, "upper_lip": 11, "lower_lip": 12,
    "hair": 13, "hat": 14, "ear_ring": 15, "necklace": 16, "neck": 17,
    "cloth": 18,
}


def remove_semantic(mask: np.ndarray, label: int,
                    fill: int = LABELS["skin"]) -> np.ndarray:
    """Replace every pixel of `label` with `fill` (reference rm_semantic)."""
    out = np.asarray(mask).copy()
    out[out == label] = fill
    return out


def switch_semantic(mask: np.ndarray, a: int, b: int) -> np.ndarray:
    """Swap two classes."""
    out = np.asarray(mask).copy()
    ma, mb = out == a, out == b
    out[ma] = b
    out[mb] = a
    return out


def transfer_semantic(
    target: np.ndarray,
    reference: np.ndarray,
    labels: tuple[int, ...],
    offset_xy: tuple[int, int] = (0, 0),
    erase_fill: int = LABELS["skin"],
    keep_on_top: tuple[int, ...] = (LABELS["hair"],),
) -> np.ndarray:
    """Cross-mask attribute transfer (reference tools.py switch_semantic
    :499-548): erase `labels` from the target (-> erase_fill), paste the
    reference mask's `labels` regions shifted by (dy, dx) = offset_xy
    (clipped at the border), then repaint `keep_on_top` classes from the
    original target, so that hair keeps covering a transplanted brow."""
    tar = np.asarray(target)
    ref = np.asarray(reference)
    out = tar.copy()
    h, w = out.shape[:2]
    for lab in labels:
        out[tar == lab] = erase_fill
    top = [(lab, np.where(tar == lab)) for lab in keep_on_top]
    dy, dx = offset_xy
    for lab in labels:
        ys, xs = np.where(ref == lab)
        ys = np.clip(ys + dy, 0, h - 1)
        xs = np.clip(xs + dx, 0, w - 1)
        out[ys, xs] = lab
        for lab_top, (ty, tx) in top:
            out[ty, tx] = lab_top
    return out


def add_semantic(mask: np.ndarray, label: int,
                 region: np.ndarray) -> np.ndarray:
    """Paint `label` over a boolean region (the painter's brush)."""
    out = np.asarray(mask).copy()
    out[np.asarray(region, bool)] = label
    return out


def dilate(region: np.ndarray, iterations: int) -> np.ndarray:
    """cv2.dilate(region, ones((3, 3)), iterations=n) on a boolean map:
    the box maximum of side 2n + 1; outside the image counts as False."""
    size = 2 * iterations + 1
    return ndimage.maximum_filter(np.asarray(region, bool), size=size,
                                  mode="constant", cval=False)


def erode(region: np.ndarray, iterations: int) -> np.ndarray:
    """cv2.erode(region, ones((3, 3)), iterations=n) on a boolean map:
    the box minimum of side 2n + 1; outside the image counts as True (a
    region that touches the border is not eroded from it)."""
    size = 2 * iterations + 1
    return ndimage.minimum_filter(np.asarray(region, bool), size=size,
                                  mode="constant", cval=True)


def scale_semantic(mask: np.ndarray, label: int, factor: float,
                   iterations: int | None = None) -> np.ndarray:
    """Grow (factor > 1) or shrink (factor < 1) a class region by
    morphological dilation / erosion (the reference's scale_semantic :551
    resizes around the component centroid; dilation gives the same edit
    without component bookkeeping)."""
    out = np.asarray(mask).copy()
    region = out == label
    if not region.any() or factor == 1.0:
        return out
    it = iterations
    if it is None:
        area = region.sum(dtype=np.int64)
        it = max(1, int(abs(factor - 1.0) * np.sqrt(area) / 2))
    if factor > 1.0:
        out[dilate(region, it)] = label
    else:
        # the vacated ring takes the dominant surrounding class (skin)
        out[region & ~erode(region, it)] = LABELS["skin"]
    return out


def simplify_mask(mask: np.ndarray, keep: tuple[int, ...] = (
        0, 1, 2, 4, 5, 6, 7, 10, 11, 12, 13, 17)) -> np.ndarray:
    """Collapse rare classes into coarse ones (reference
    gen_face_simplifed_mask :86): glasses -> skin, hat -> hair,
    accessories -> the nearest body class."""
    remap = {
        LABELS["eye_glasses"]: LABELS["skin"],
        LABELS["left_ear"]: LABELS["skin"],
        LABELS["right_ear"]: LABELS["skin"],
        LABELS["hat"]: LABELS["hair"],
        LABELS["ear_ring"]: LABELS["skin"],
        LABELS["necklace"]: LABELS["neck"],
        LABELS["cloth"]: LABELS["neck"],
    }
    out = np.asarray(mask).copy()
    for src, dst in remap.items():
        if src not in keep:
            out[out == src] = dst
    return out


def colorize(mask: np.ndarray) -> np.ndarray:
    """19-class mask -> palette RGB (Painter/ui/util.py number_color)."""
    return CELEBA_PALETTE[np.asarray(mask) % len(CELEBA_PALETTE)]


def color_to_mask(rgb: np.ndarray) -> np.ndarray:
    """Inverse of colorize: palette RGB image -> class ids (nearest
    colour)."""
    rgb = np.asarray(rgb, dtype=np.int32)
    d = np.linalg.norm(
        rgb[..., None, :] - CELEBA_PALETTE[None, None, :, :], axis=-1)
    return np.argmin(d, axis=-1).astype(np.uint8)
