"""Gaps between what the timed path produced and the plain reference."""
from __future__ import annotations

import numpy as np


def render_gaps(pairs) -> dict:
    """pairs: [(program pixels, reference pixels, program depth, reference
    depth)] as arrays. -> pixel_rms (root mean square of the pixel gap over
    every sampled image, channel and pixel, on the [-1, 1] scale),
    pixel_max (the widest single gap) and depth_rms."""
    dp = np.concatenate([np.ravel(np.asarray(p, np.float64)
                                  - np.asarray(r, np.float64))
                         for p, r, _, _ in pairs])
    dd = np.concatenate([np.ravel(np.asarray(p, np.float64)
                                  - np.asarray(r, np.float64))
                         for _, _, p, r in pairs])
    bad = lambda d: not np.all(np.isfinite(d))
    return {"pixel_rms": float("inf") if bad(dp)
            else float(np.sqrt(np.mean(dp ** 2))),
            "pixel_max": float("inf") if bad(dp) else float(np.abs(dp).max()),
            "depth_rms": float("inf") if bad(dd)
            else float(np.sqrt(np.mean(dd ** 2)))}


def sample(rng: np.random.Generator, n: int, k: int) -> list:
    """k distinct indices of range(n) (all when k >= n), sorted, the last
    index always among them."""
    if k >= n:
        return list(range(n))
    picked = set(rng.choice(n - 1, size=k - 1, replace=False).tolist())
    return sorted(picked | {n - 1})


def leaf_norm_gap(prog: dict, ref: dict) -> tuple[float, list]:
    """The widest gap, leaf by leaf, between the program's and the
    reference's norm of each leaf ({path: tensor}), over the larger of the
    reference leaf's norm and the median leaf's; and the paths whose
    reference norm is at least a thousandth of the median's."""
    norms = {p: float(t.double().norm()) for p, t in ref.items()}
    med = float(np.median(list(norms.values())))
    gap = 0.0
    for p, n in norms.items():
        d = abs(float(prog[p].double().norm()) - n) / max(n, med, 1e-30)
        gap = max(gap, d if np.isfinite(d) else float("inf"))
    return gap, [p for p, n in norms.items() if n >= 1e-3 * med]
