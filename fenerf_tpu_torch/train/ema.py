"""Exponential moving average of parameter trees (port of
fenerf_tpu/train/ema.py), with torch_ema's warm-up:

    decay_eff(n) = min(decay, (1 + n) / (10 + n)),  n = updates so far + 1
    e <- e - (1 - decay_eff) * (e - p)

The trainer keeps two (0.999 and 0.9999) and updates both after every
generator step.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from fenerf_tpu_torch.compat.jax_bridge import tree_leaves, tree_map

Params = Any


class EmaState(NamedTuple):
    params: Params
    decay: float
    num_updates: int


def ema_init(params: Params, decay: float) -> EmaState:
    """A copy of `params` (never aliasing them) with no updates yet."""
    return EmaState(tree_map(lambda t: t.detach().clone(), params),
                    float(decay), 0)


@torch.no_grad()
def ema_update(state: EmaState, params: Params) -> EmaState:
    """One update, in place on the EMA's own tensors."""
    n = state.num_updates + 1
    # f32 arithmetic, as the JAX package's (decay is an f32 there)
    f32 = np.float32
    decay = min(f32(state.decay), (f32(1.0) + f32(n)) / (f32(10.0) + f32(n)))
    one_minus = float(f32(1.0) - decay)
    for e, p in zip(tree_leaves(state.params), tree_leaves(params)):
        e.sub_(one_minus * (e - p))
    return EmaState(state.params, state.decay, n)
