"""A synthetic CelebAMask-HQ tree for driving the trainer without the
dataset: <root>/celebahq_mask_img/*.jpg (given JPEG files, e.g. the
fixture set tests/data/celebamask_synth, made by
scripts/make_celebamask_fixtures.py) and <root>/celebahq_mask_mask/*.png
label maps written by the port's PNG encoder (uint8 classes 0-18 in smooth
regions: background outside an ellipse, a seeded low-frequency partition
of the classes 1-18 inside), at CelebAMask-HQ's 512 x 512 mask size.

Also `fixture_digests`, the fixture set's decoded.sha256 as a dict.
"""
from __future__ import annotations

import os
import shutil
from pathlib import Path

import numpy as np

from fenerf_tpu_torch.utils.image import resize, save_png

FIXTURES = Path(__file__).resolve().parents[2] / "tests" / "data" / \
    "celebamask_synth"
N_CLASSES = 19
MASK_SIZE = 512


def label_map(rng: np.random.Generator, size: int = MASK_SIZE) -> np.ndarray:
    """(size, size) uint8 classes: 0 outside an ellipse, inside the argmax
    of 18 smooth random fields (bilinear upsampling of 6 x 6 noise to 64 x
    64) + 1, NEAREST-upsampled to size."""
    lo = rng.integers(0, 256, (6, 6, N_CLASSES - 1), dtype=np.uint8)
    fields = resize(lo, (64, 64), "bilinear")
    labels = (np.argmax(fields, axis=-1) + 1).astype(np.uint8)
    labels = resize(labels, (size, size), "nearest")
    y, x = np.mgrid[0:size, 0:size] / size
    cx, cy = rng.uniform(0.4, 0.6, 2)
    inside = ((x - cx) / 0.32) ** 2 + ((y - cy) / 0.42) ** 2 < 1.0
    return np.where(inside, labels, 0).astype(np.uint8)


def write_celebamask_tree(root: str, images, count: int | None = None,
                          seed: int = 0, mask_size: int = MASK_SIZE) -> str:
    """`count` pairs (default: one per image): the JPEGs `images` copied
    in turn, each pair with a label PNG of its own; -> root."""
    images = sorted(images)
    count = count or len(images)
    img_dir = os.path.join(root, "celebahq_mask_img")
    mask_dir = os.path.join(root, "celebahq_mask_mask")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(count):
        shutil.copy(images[i % len(images)],
                    os.path.join(img_dir, f"{i:05d}.jpg"))
        save_png(os.path.join(mask_dir, f"{i:05d}.png"),
                 label_map(rng, mask_size))
    return root


def fixture_digests(directory: Path = FIXTURES) -> dict[str, str]:
    """{file name: SHA-256 of PIL's RGB decode} of the fixture set."""
    out = {}
    for line in (directory / "decoded.sha256").read_text().splitlines():
        digest, name = line.split()
        out[name] = digest
    return out
