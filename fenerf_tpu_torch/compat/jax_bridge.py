"""Parameter trees between the JAX package's layout and torch tensors,
without JAX.

A parameter tree is nested dicts / lists of arrays. Leaves are ordered as
jax.tree_util orders them: dict keys sorted, lists in index order (so a
Linear's 'b' comes before its 'w'). The JAX package's `.npz` generator
checkpoints (fenerf_tpu/apps/common.py::save_generator) store leaves in
exactly that order, so reading and writing them is a plain copy; Linear
weights keep their (in, out) layout. The latent-grid family's tree sorts
the same way: color, color_head, map, sigma_head, style_gen, trunk, and
inside style_gen conv1 before convs.

Python int and bool leaves (the patch critics' per-layer `stride` and
`sn`) are static structure, not parameters: both conversions carry them
across as they are.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def tree_leaves(tree: Any) -> list:
    """Leaves in jax.tree_util order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(template: Any, leaves: list) -> Any:
    """A tree shaped like `template` holding `leaves` (tree_leaves order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(template)
    rest = sum(1 for _ in it)
    if rest:
        raise ValueError(f"{rest} leaves left over for the template")
    return out


def tree_map(fn: Callable, tree: Any) -> Any:
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


def _static(x) -> bool:
    """A Python int or bool leaf (numpy and torch scalars are arrays)."""
    return isinstance(x, (bool, int))


def from_numpy_tree(tree: Any, device="cpu") -> Any:
    """JAX-layout numpy tree (e.g. jax.tree.map(np.asarray, params)) ->
    the same tree of torch tensors on `device` (floats as float32);
    Python int / bool leaves stay as they are."""
    def conv(x):
        if _static(x):
            return x
        t = torch.from_numpy(np.array(x, copy=True))
        return t.to(device=device,
                    dtype=torch.float32 if t.is_floating_point() else t.dtype)
    return tree_map(conv, tree)


def to_numpy_tree(tree: Any) -> Any:
    """Torch tree -> the same tree of numpy arrays (float32 for floats);
    Python int / bool leaves stay as they are."""
    def conv(t):
        if _static(t):
            return t
        t = t.detach().cpu()
        if t.is_floating_point():
            t = t.to(torch.float32)
        return t.numpy()
    return tree_map(conv, tree)


TRAIN_PARAMS = ("g_params", "d_img_params", "d_seg_params")


def train_params_from_numpy(state: Any, device="cpu") -> dict:
    """The three networks of a JAX TrainState (an object with numpy-leaf
    trees as attributes g_params, d_img_params, d_seg_params, e.g.
    jax.tree.map(np.asarray, state)) as torch trees on `device`."""
    return {k: from_numpy_tree(getattr(state, k), device)
            for k in TRAIN_PARAMS}


def train_params_to_numpy(state: Any) -> dict:
    """The three networks of a port TrainState as numpy trees in the JAX
    layout, by the JAX TrainState's field names."""
    return {k: to_numpy_tree(getattr(state, k)) for k in TRAIN_PARAMS}
