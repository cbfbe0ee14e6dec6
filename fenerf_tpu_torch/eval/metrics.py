"""KID, Inception Score, PSNR and SSIM on the host (port of
fenerf_tpu/eval/metrics.py; numpy).

The reference's eval_metrics.py scores through torch-fidelity; the math
is written out here as the JAX package writes it, and the feature / logit
extractor is pluggable as in eval/fid.py.

KID: polynomial-kernel MMD^2 between feature sets (Binkowski et al. 2018),
the block-averaged unbiased estimator as torch-fidelity computes it.
IS: exp(E_x KL(p(y|x) || p(y))) over classifier logits.
"""
from __future__ import annotations

import numpy as np


def polynomial_kernel(x: np.ndarray, y: np.ndarray, degree: int = 3,
                      gamma: float | None = None, coef0: float = 1.0):
    d = x.shape[1]
    gamma = gamma if gamma is not None else 1.0 / d
    return (x @ y.T * gamma + coef0) ** degree


def mmd2_unbiased(kxx: np.ndarray, kyy: np.ndarray, kxy: np.ndarray) -> float:
    m = kxx.shape[0]
    n = kyy.shape[0]
    sum_xx = (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
    sum_yy = (kyy.sum() - np.trace(kyy)) / (n * (n - 1))
    sum_xy = kxy.mean()
    return float(sum_xx + sum_yy - 2 * sum_xy)


def kid(features_real: np.ndarray, features_fake: np.ndarray,
        n_subsets: int = 100, subset_size: int = 1000,
        seed: int = 0) -> tuple[float, float]:
    """Block-averaged KID (mean, std) as in torch-fidelity."""
    rng = np.random.RandomState(seed)
    m = min(subset_size, len(features_real), len(features_fake))
    vals = []
    for _ in range(n_subsets):
        xi = features_real[rng.choice(len(features_real), m, replace=False)]
        yi = features_fake[rng.choice(len(features_fake), m, replace=False)]
        vals.append(mmd2_unbiased(
            polynomial_kernel(xi, xi), polynomial_kernel(yi, yi),
            polynomial_kernel(xi, yi)))
    return float(np.mean(vals)), float(np.std(vals))


def inception_score(logits: np.ndarray, n_splits: int = 10
                    ) -> tuple[float, float]:
    """IS from classifier logits (N, n_classes)."""
    logits = np.asarray(logits, dtype=np.float64)
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    scores = []
    n = len(probs)
    for i in range(n_splits):
        part = probs[i * n // n_splits:(i + 1) * n // n_splits]
        if not len(part):
            continue
        marginal = part.mean(axis=0, keepdims=True)
        kl = np.sum(part * (np.log(part + 1e-12) - np.log(marginal + 1e-12)),
                    axis=1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores)), float(np.std(scores))


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 2.0) -> float:
    """Peak signal-to-noise ratio (default range 2.0 for [-1,1] images)."""
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 2.0,
         win: int = 7) -> float:
    """Mean structural similarity over (C, H, W) or (H, W) images, the
    uniform-window variant (the JAX package's; no skimage)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[None], b[None]
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    def box(x):
        # separable uniform filter, valid region
        k = np.ones(win) / win
        x = np.apply_along_axis(lambda r: np.convolve(r, k, "valid"), 1, x)
        x = np.apply_along_axis(lambda r: np.convolve(r, k, "valid"), 2, x)
        return x

    mu_a, mu_b = box(a), box(b)
    saa = box(a * a) - mu_a ** 2
    sbb = box(b * b) - mu_b ** 2
    sab = box(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * sab + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (saa + sbb + c2))
    return float(s.mean())
