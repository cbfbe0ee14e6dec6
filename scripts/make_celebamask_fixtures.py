"""Writes the JPEG fixture set of the port's data path:
tests/data/celebamask_synth/{00000..00007}.jpg (1024 x 1024, seeded smooth
portrait-like content, PIL quality 90, 4:2:0) and decoded.sha256, the
SHA-256 of PIL's RGB decode of each file (row-major uint8 bytes).

The native decoder (fenerf_tpu_torch/data/native/codec.cpp) is held to
these digests wherever it is built (tests/test_torch_data.py on the CPU,
chip_smoke.py's train CLI phase on the card's machine). Needs PIL and
numpy; it is not run by the tests or on the card.

  python scripts/make_celebamask_fixtures.py [--seed 0] [--count 8]
"""
from __future__ import annotations

import argparse
import hashlib
import io
from pathlib import Path

import numpy as np
from PIL import Image

OUT = Path(__file__).resolve().parents[1] / "tests" / "data" / \
    "celebamask_synth"
SIZE = 1024


def portrait(rng: np.random.Generator, size: int = SIZE) -> np.ndarray:
    """(size, size, 3) uint8: a smooth background gradient, an elliptic
    'face' with a few darker blobs, low-frequency colour noise and a little
    fine grain."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    bg = rng.uniform(40, 200, 3)
    gx, gy = rng.uniform(-60, 60, 3), rng.uniform(-60, 60, 3)
    img = bg + gx * x[..., None] + gy * y[..., None]
    cx, cy = rng.uniform(0.4, 0.6, 2)
    ax, ay = rng.uniform(0.22, 0.3), rng.uniform(0.3, 0.38)
    face = ((x - cx) / ax) ** 2 + ((y - cy) / ay) ** 2
    skin = rng.uniform(150, 230, 3) * np.array([1.0, 0.8, 0.7])
    w = 1.0 / (1.0 + np.exp((face - 1.0) * 30.0))
    img = img * (1 - w[..., None]) + skin * w[..., None]
    for _ in range(5):
        bx, by = cx + rng.uniform(-0.15, 0.15), cy + rng.uniform(-0.2, 0.2)
        r = rng.uniform(0.02, 0.06)
        d = ((x - bx) ** 2 + (y - by) ** 2) / r ** 2
        img = img - rng.uniform(30, 90) * np.exp(-d)[..., None]
    lo = rng.normal(0, 12, (9, 9, 3)).astype(np.float32)
    lo = np.asarray(Image.fromarray(np.clip(lo + 128, 0, 255)
                                    .astype(np.uint8)).resize(
        (size, size), Image.BICUBIC), np.float32) - 128
    img = img + lo + rng.normal(0, 2.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--count", type=int, default=8)
    p.add_argument("--out", default=str(OUT))
    args = p.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    lines = []
    for i in range(args.count):
        buf = io.BytesIO()
        Image.fromarray(portrait(rng)).save(buf, "JPEG", quality=90,
                                            subsampling=2)
        name = f"{i:05d}.jpg"
        (out / name).write_bytes(buf.getvalue())
        decoded = np.asarray(Image.open(out / name).convert("RGB"))
        lines.append(f"{hashlib.sha256(decoded.tobytes()).hexdigest()}  "
                     f"{name}")
        print(name, len(buf.getvalue()), "bytes")
    (out / "decoded.sha256").write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
