"""The FID evaluation protocol (port of fenerf_tpu/eval/fid.py; reference
fid_evaluation.py:78-162).

Protocol: dump `num_real` real images once (setup_evaluation, 8000 at
target_size); every eval_freq steps render `num_eval` EMA samples
(output_images, 2048 at 128 px); the Frechet distance between the two
feature gaussians (calculate_fid).

The feature extractor is pluggable: `inception_features` loads
pytorch-fid's InceptionV3 (nn/inception.py) from $FENERF_INCEPTION_WEIGHTS
and raises FileNotFoundError without it; tests pass a feature function of
their own. PNGs are written and read by utils/image.py (no PIL).
"""
from __future__ import annotations

import glob
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fenerf_tpu_torch.utils.image import read_png, resize, save_png, to_mode

WEIGHTS_ENV = "FENERF_INCEPTION_WEIGHTS"


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID between two gaussians; the covariance square root by scipy's
    sqrtm."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def feature_statistics(features: np.ndarray):
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def fid_from_features(f1: np.ndarray, f2: np.ndarray) -> float:
    return frechet_distance(*feature_statistics(f1), *feature_statistics(f2))


# ---------------------------------------------------------------------------
# Protocol
# ---------------------------------------------------------------------------

def _to_u8(chw: np.ndarray) -> np.ndarray:
    """(3, H, W) in [-1, 1] -> (H, W, 3) uint8, rounded as the reference."""
    return np.clip((np.asarray(chw).transpose(1, 2, 0) + 1) * 127.5 + 0.5,
                   0, 255).astype(np.uint8)


def setup_evaluation(dataset, real_dir: str, target_size: int = 128,
                     num_real: int = 8000) -> None:
    """Dump the real images once (reference setup_evaluation :78-95),
    bilinearly resized to target_size as PIL resizes them."""
    if os.path.exists(real_dir) and len(os.listdir(real_dir)) >= min(
            num_real, len(dataset)):
        return
    os.makedirs(real_dir, exist_ok=True)

    def dump(i):
        arr = _to_u8(dataset.__getitem__(i)[0])
        if arr.shape[:2] != (target_size, target_size):
            arr = resize(arr, (target_size, target_size), "bilinear")
        save_png(os.path.join(real_dir, f"{i:06d}.png"), arr)

    # the items decode on a pool of threads (the codec drops the GIL)
    with ThreadPoolExecutor(min(os.cpu_count() or 1, 8)) as pool:
        list(pool.map(dump, range(min(num_real, len(dataset)))))


def output_images(render_fn, gen_dir: str, num_eval: int = 2048,
                  batch_size: int = 16, host_index: int = 0,
                  n_hosts: int = 1, seed: int = 0, device="cpu") -> None:
    """Render EMA samples round-robin over hosts (reference
    output_images_double :126-152). render_fn(generator, n) -> (n, 3, H, W)
    in [-1, 1]; batch i draws from a torch.Generator on `device` seeded
    (seed, i). Returns the indices of the images this host wrote."""
    os.makedirs(gen_dir, exist_ok=True)
    idx = 0
    batch_id = 0
    written = []
    while idx < num_eval:
        if batch_id % n_hosts == host_index:
            g = torch.Generator(device=device).manual_seed(
                seed * 1_000_003 + batch_id)
            imgs = render_fn(g, batch_size)
            if isinstance(imgs, torch.Tensor):
                imgs = imgs.detach().float().cpu().numpy()
            for j in range(min(batch_size, num_eval - idx)):
                save_png(os.path.join(gen_dir, f"{idx + j:06d}.png"),
                         _to_u8(imgs[j]))
                written.append(idx + j)
        idx += batch_size
        batch_id += 1
    return written


def _load_images(d: str, limit: int | None = None) -> np.ndarray:
    files = sorted(glob.glob(os.path.join(d, "*.png")))[:limit]
    assert files, f"no images in {d}"
    return np.stack([to_mode(read_png(f), "RGB").astype(np.float32) / 255.0
                     for f in files])


def calculate_fid(real_dir: str, gen_dir: str, feature_fn=None,
                  batch_size: int = 64) -> float:
    """Frechet distance between two directories of PNGs (reference
    calculate_fid :155-162). feature_fn(images (N, H, W, 3) in [0, 1])
    -> (N, D); default: InceptionV3 (weights-gated)."""
    feature_fn = feature_fn or inception_features()
    feats = []
    for d in (real_dir, gen_dir):
        imgs = _load_images(d)
        fs = [np.asarray(feature_fn(imgs[i:i + batch_size]))
              for i in range(0, len(imgs), batch_size)]
        feats.append(np.concatenate(fs))
    return fid_from_features(feats[0], feats[1])


def inception_features(path: str | None = None, device="cuda"):
    """The InceptionV3 pool3 feature function (nn/inception.py) on
    `device`, from $FENERF_INCEPTION_WEIGHTS (an .npz of
    nn.inception.export_npz, either package's). Raises FileNotFoundError
    without one; tests pass a feature_fn of their own instead."""
    path = path or os.environ.get(WEIGHTS_ENV)
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            "InceptionV3 weights unavailable. Set "
            f"${WEIGHTS_ENV} to an .npz exported from pytorch-fid's "
            "InceptionV3 (nn/inception.py::export_npz) for a reference-"
            "comparable FID, or pass feature_fn= explicitly.")
    from fenerf_tpu_torch.nn.inception import inception_pool3, load_npz

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to "
                           "score on the CPU")
    params = load_npz(path, dev)

    @torch.no_grad()
    def features(imgs):
        x = torch.as_tensor(np.asarray(imgs, np.float32), device=dev)
        return inception_pool3(params, x).cpu().numpy()

    return features
