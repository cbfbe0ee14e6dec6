"""The port's face alignment (fenerf_tpu_torch/utils/align.py) and its
PIL-exact pieces (utils/image.py: resize(..., "lanczos") and
quad_transform) against PIL and the JAX package's align_face (which runs
on PIL), bit for bit, on seeded images, quads and landmarks."""
import sys

import numpy as np
import pytest
from PIL import Image

from fenerf_tpu.utils import align as jalign
from fenerf_tpu_torch.utils import align as talign
from fenerf_tpu_torch.utils.image import quad_transform, resize


def _image(rng, h, w, channels):
    shape = (h, w) if channels == 1 else (h, w, channels)
    a = rng.randint(0, 256, shape).astype(np.uint8)
    # smooth parts and edges, not noise alone
    return np.asarray(Image.fromarray(a).resize((w // 3 + 1, h // 3 + 1))
                      .resize((w, h), Image.BILINEAR))


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("src,dst", [((37, 53), (128, 100)),
                                     ((120, 96), (31, 45)),
                                     ((256, 256), (64, 64)),
                                     ((64, 80), (64, 33)),
                                     ((50, 40), (50, 97))])
def test_lanczos_resize_is_pils(mode, src, dst):
    rng = np.random.RandomState(src[0] + dst[1])
    img = _image(rng, *src, 1 if mode == "L" else 3)
    ref = np.asarray(Image.fromarray(img, mode).resize(dst, Image.LANCZOS))
    np.testing.assert_array_equal(resize(img, dst, "lanczos"), ref,
                                  strict=True)


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("seed", range(4))
def test_quad_transform_is_pils(mode, seed):
    """Seeded quads, every second one reaching outside the image (its
    samples there are 0) and one degenerate to a line."""
    rng = np.random.RandomState(10 + seed)
    h, w = 48 + 7 * seed, 40 + 11 * seed
    img = _image(rng, h, w, 1 if mode == "L" else 3)
    quads = [rng.uniform(0.1, 0.9, 8), rng.uniform(-0.4, 1.4, 8),
             np.array([0.2, 0.2, 0.2, 0.8, 0.2, 0.8, 0.2, 0.2])]
    for q in quads:
        data = q * np.array([w, h] * 4)
        for size in ((32, 32), (17, 29)):
            ref = np.asarray(Image.fromarray(img, mode).transform(
                size, Image.QUAD, tuple(data), Image.BILINEAR))
            np.testing.assert_array_equal(quad_transform(img, size, data),
                                          ref, strict=True)


def _landmarks(rng, cx, cy, eye, mouth):
    lm = rng.uniform(-3, 3, (68, 2)) + [cx, cy]
    lm[36:42] = [cx - eye / 2, cy] + rng.uniform(-2, 2, (6, 2))
    lm[42:48] = [cx + eye / 2, cy] + rng.uniform(-2, 2, (6, 2))
    lm[48] = [cx - eye / 3, cy + mouth] + rng.uniform(-2, 2, 2)
    lm[54] = [cx + eye / 3, cy + mouth] + rng.uniform(-2, 2, 2)
    return lm


def test_alignment_quad_is_the_jax_one():
    rng = np.random.RandomState(0)
    for _ in range(5):
        lm = rng.uniform(0, 500, (68, 2))
        q_t, s_t = talign.alignment_quad(lm)
        q_j, s_j = jalign.alignment_quad(lm)
        np.testing.assert_array_equal(q_t, q_j, strict=True)
        assert s_t == s_j


def _branches(lm, size, output_size):
    """Which of align_face's branches the landmarks take: (shrink > 1,
    crop, pad), by the JAX function's arithmetic."""
    quad, qsize = jalign.alignment_quad(lm)
    shrink = int(np.floor(qsize / output_size * 0.5))
    if shrink > 1:
        size = int(np.rint(size / shrink))
        quad, qsize = quad / shrink, qsize / shrink
    border = max(int(np.rint(qsize * 0.1)), 3)
    lo = np.floor(quad.min(axis=0)).astype(int) - border
    hi = np.ceil(quad.max(axis=0)).astype(int) + border
    c0, c1 = np.maximum(lo, 0), np.minimum(hi, size)
    crop = bool(((c1 - c0) < size).any())
    if crop:
        quad = quad - c0
        size = c1 - c0
    pad = max(max(border - np.floor(quad.min(axis=0)).astype(int)),
              max(np.ceil(quad.max(axis=0)).astype(int) - size + border))
    return shrink > 1, crop, pad > border - 4


# (image side, eye centre x, y, eye distance, eye-to-mouth, output size,
#  transform size, branches taken)
ALIGN_CASES = {
    "shrink_crop_pad": (1024, 350, 350, 260, 200, 256, 256,
                        (True, True, True)),
    "shrink_pad": (1024, 512, 420, 300, 220, 256, 256, (True, False, True)),
    "crop": (640, 300, 260, 90, 70, 128, 128, (False, True, False)),
    "final_resize": (300, 150, 140, 60, 50, 64, 128, (False, True, False)),
}


@pytest.mark.parametrize("case", sorted(ALIGN_CASES))
def test_align_face_is_the_jax_one(case):
    size, cx, cy, eye, mouth, out, tr, branches = ALIGN_CASES[case]
    rng = np.random.RandomState(len(case))
    img = _image(rng, size, size, 3)
    lm = _landmarks(rng, cx, cy, eye, mouth)
    assert _branches(lm, size, out) == branches
    ref = np.asarray(jalign.align_face(Image.fromarray(img), lm.copy(), out,
                                       tr))
    got = talign.align_face(img, lm.copy(), out, tr)
    assert got.shape == (out, out, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref, strict=True)


def test_detect_landmarks_without_dlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "dlib", None)   # import fails
    with pytest.raises(RuntimeError, match="dlib is not installed"):
        talign.detect_landmarks("face.jpg", "shape_predictor.dat")
