"""Plot helpers for inversion/eval artifacts (the port's own copy of
fenerf_tpu/utils/plots.py; needs matplotlib, imported at call time).

Reference: tools.py:636-666 plot_miou — scatter of the inversion's mIoU
trace (mious.npy, one entry per 20 optimization iterations) with a
confidence band, saved as miou.png next to the data. (The reference adds a
+0.2 offset to the values before plotting; that is a figure-styling hack and
is NOT reproduced — we plot the measured values.)
"""
from __future__ import annotations

import os

import numpy as np


def plot_miou(save_dir: str, log_every: int = 20) -> str:
    """Render <save_dir>/mious.npy to <save_dir>/miou.png; returns the path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    mious = np.load(os.path.join(save_dir, "mious.npy"))
    steps = np.arange(len(mious)) * log_every
    ci = 2 * np.std(mious) / np.sqrt(max(len(steps), 1))

    fig, ax = plt.subplots()
    ax.scatter(steps, mious, s=8, alpha=0.7, color="b")
    ax.fill_between(steps, mious - ci, mious + ci, color="b", alpha=0.4)
    ax.set_ylabel("MIoU")
    ax.set_xlabel("Iterations")
    ax.autoscale(tight=True)
    out = os.path.join(save_dir, "miou.png")
    fig.savefig(out)
    plt.close(fig)
    return out
