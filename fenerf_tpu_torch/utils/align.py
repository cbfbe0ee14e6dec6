"""FFHQ-style face alignment (port of fenerf_tpu/utils/align.py), on
(H, W, 3) uint8 arrays: the card's machine has no PIL.

The standard FFHQ recipe: 68 landmarks -> an oriented crop quad from the
eye and mouth geometry -> shrink, crop, reflect-pad and blur -> PIL's QUAD
transform to the output size. The resizes and the QUAD transform are the
port's PIL-exact numpy copies (utils/image.py), so the result equals the
JAX package's PIL pipeline bit for bit. Landmark detection needs dlib,
imported only inside `detect_landmarks`; any 68-point detector's output
can drive `align_face`.
"""
from __future__ import annotations

import numpy as np

from fenerf_tpu_torch.utils.image import quad_transform, resize


def detect_landmarks(filepath: str, predictor_path: str) -> np.ndarray:
    """dlib 68-landmark detection. Raises RuntimeError when dlib is not
    installed."""
    try:
        import dlib  # noqa: PLC0415
    except ImportError as e:
        raise RuntimeError(
            "dlib is not installed; obtain 68-point landmarks from any "
            "detector and call align_face(img, landmarks) directly.") from e
    detector = dlib.get_frontal_face_detector()
    predictor = dlib.shape_predictor(predictor_path)
    img = dlib.load_rgb_image(filepath)
    dets = detector(img, 1)
    assert dets, "no face detected"
    shape = predictor(img, dets[0])
    return np.array([[p.x, p.y] for p in shape.parts()], np.float64)


def alignment_quad(lm: np.ndarray) -> tuple[np.ndarray, float]:
    """68 landmarks -> (oriented crop quad (4,2), qsize) — the FFHQ recipe."""
    lm = np.asarray(lm, np.float64)
    eye_left = lm[36:42].mean(axis=0)
    eye_right = lm[42:48].mean(axis=0)
    eye_avg = (eye_left + eye_right) * 0.5
    eye_to_eye = eye_right - eye_left
    mouth_avg = (lm[48] + lm[54]) * 0.5
    eye_to_mouth = mouth_avg - eye_avg

    x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
    x /= np.hypot(*x)
    x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
    y = np.flipud(x) * [-1, 1]
    c = eye_avg + eye_to_mouth * 0.1
    quad = np.stack([c - x - y, c - x + y, c + x + y, c + x - y])
    return quad, float(np.hypot(*x) * 2)


def align_face(img: np.ndarray, landmarks: np.ndarray,
               output_size: int = 256, transform_size: int = 256,
               enable_padding: bool = True) -> np.ndarray:
    """Align an (H, W, 3) uint8 face image given its 68 landmarks ->
    (output_size, output_size, 3) uint8."""
    import scipy.ndimage

    img = np.asarray(img, np.uint8)
    quad, qsize = alignment_quad(landmarks)
    size = lambda: (img.shape[1], img.shape[0])   # PIL's (w, h)

    shrink = int(np.floor(qsize / output_size * 0.5))
    if shrink > 1:
        rsize = (int(np.rint(size()[0] / shrink)),
                 int(np.rint(size()[1] / shrink)))
        img = resize(img, rsize, "lanczos")
        quad /= shrink
        qsize /= shrink

    border = max(int(np.rint(qsize * 0.1)), 3)
    crop = (int(np.floor(quad[:, 0].min())), int(np.floor(quad[:, 1].min())),
            int(np.ceil(quad[:, 0].max())), int(np.ceil(quad[:, 1].max())))
    crop = (max(crop[0] - border, 0), max(crop[1] - border, 0),
            min(crop[2] + border, size()[0]),
            min(crop[3] + border, size()[1]))
    if crop[2] - crop[0] < size()[0] or crop[3] - crop[1] < size()[1]:
        img = img[crop[1]:crop[3], crop[0]:crop[2]]
        quad -= crop[0:2]

    pad = (int(np.floor(quad[:, 0].min())), int(np.floor(quad[:, 1].min())),
           int(np.ceil(quad[:, 0].max())), int(np.ceil(quad[:, 1].max())))
    pad = (max(-pad[0] + border, 0), max(-pad[1] + border, 0),
           max(pad[2] - size()[0] + border, 0),
           max(pad[3] - size()[1] + border, 0))
    if enable_padding and max(pad) > border - 4:
        pad = np.maximum(pad, int(np.rint(qsize * 0.3)))
        arr = np.pad(np.float32(img),
                     ((pad[1], pad[3]), (pad[0], pad[2]), (0, 0)), "reflect")
        h, w, _ = arr.shape
        yy, xx, _ = np.ogrid[:h, :w, :1]
        mask = np.maximum(
            1.0 - np.minimum(np.float32(xx) / max(pad[0], 1),
                             np.float32(w - 1 - xx) / max(pad[2], 1)),
            1.0 - np.minimum(np.float32(yy) / max(pad[1], 1),
                             np.float32(h - 1 - yy) / max(pad[3], 1)))
        blur = qsize * 0.02
        arr += (scipy.ndimage.gaussian_filter(arr, [blur, blur, 0]) - arr) \
            * np.clip(mask * 3.0 + 1.0, 0.0, 1.0)
        arr += (np.median(arr, axis=(0, 1)) - arr) * np.clip(mask, 0.0, 1.0)
        img = np.uint8(np.clip(np.rint(arr), 0, 255))
        quad += pad[:2]

    img = quad_transform(img, (transform_size, transform_size),
                         (quad + 0.5).flatten())
    if output_size < transform_size:
        img = resize(img, (output_size, output_size), "lanczos")
    return img
