"""Train-state checkpoints in the JAX package's `.npz` layout (port of
fenerf_tpu/utils/checkpoint.py for the trainer's TrainState).

The file holds `leaf_{i}` arrays in jax.tree_util order of the JAX
package's TrainState plus a `__manifest__` JSON with the leaf count, so a
`train_state.npz` written by `fenerf_tpu.apps.train` resumes in the port
and the port's loads back in `fenerf_tpu.utils.checkpoint.load`. That
order is:

  g_params, d_img_params, d_seg_params   (dict keys sorted)
  opt_g, opt_img, opt_seg                optax states: clip (no leaves),
      then Adam's (count int32, mu, nu); a generator with unique_lr has
      optax.multi_transform's two partitions, "main" then "map", each
      (count, mu, nu) over its own top-level keys
  ema, ema2                              (params, decay f32, updates i32)
  step                                   int32
"""
from __future__ import annotations

import json
import os
from typing import Iterator

import numpy as np
import torch

from fenerf_tpu_torch.compat.jax_bridge import tree_leaves, tree_unflatten
from fenerf_tpu_torch.train.ema import EmaState
from fenerf_tpu_torch.train.loop import AdamState, TrainState

_NETS = ("g_params", "d_img_params", "d_seg_params")
_OPTS = ("opt_g", "opt_img", "opt_seg")
_EMAS = ("ema", "ema2")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _adam_parts(opt: AdamState) -> list[list[str]]:
    """The top-level keys of each optax partition, in leaf order."""
    keys = sorted(opt.mu)
    if not opt.split:
        return [keys]
    return [[k for k in keys if k not in opt.split],
            [k for k in keys if k in opt.split]]


def state_leaves(state: TrainState) -> list[np.ndarray]:
    """Every leaf of `state` as numpy, in the JAX TrainState's order."""
    out = []
    for name in _NETS:
        out += [_np(t) for t in tree_leaves(getattr(state, name))]
    for name in _OPTS:
        opt = getattr(state, name)
        for keys in _adam_parts(opt):
            out.append(np.asarray(opt.count, np.int32))
            for moment in (opt.mu, opt.nu):
                out += [_np(t) for k in keys for t in tree_leaves(moment[k])]
    for name in _EMAS:
        ema = getattr(state, name)
        out += [_np(t) for t in tree_leaves(ema.params)]
        out += [np.asarray(ema.decay, np.float32),
                np.asarray(ema.num_updates, np.int32)]
    out.append(np.asarray(state.step, np.int32))
    return out


def save(path: str, state: TrainState) -> None:
    """Write `state` as a `.npz` the JAX package's `load` reads (atomic
    rename)."""
    leaves = state_leaves(state)
    arrays = {f"leaf_{i}": x for i, x in enumerate(leaves)}
    manifest = json.dumps({"treedef": "TrainState (fenerf_tpu_torch)",
                           "n": len(leaves)})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"  # the suffix stops np.savez appending its own
    np.savez(tmp, __manifest__=manifest, **arrays)
    os.replace(tmp, path)


def load(path: str, like: TrainState) -> TrainState:
    """A TrainState from a `.npz` of either package. `like` (e.g. a fresh
    state of the same configuration) gives the structure, the devices and
    the dtypes; shapes must match leaf for leaf."""
    with np.load(path, allow_pickle=False) as data:
        n = json.loads(str(data["__manifest__"]))["n"]
        arrays = [data[f"leaf_{i}"] for i in range(n)]
    it: Iterator[np.ndarray] = iter(arrays)
    taken = [0]

    def take(template: torch.Tensor | None = None):
        try:
            x = next(it)
        except StopIteration:
            raise ValueError(f"{path}: {n} leaves, fewer than the state "
                             f"has; configuration mismatch?") from None
        taken[0] += 1
        if template is None:
            return x
        if tuple(x.shape) != tuple(template.shape):
            raise ValueError(f"{path}: leaf {taken[0] - 1} has shape "
                             f"{x.shape}, the state {tuple(template.shape)}")
        return torch.from_numpy(np.array(x)).to(template.device,
                                                template.dtype)

    def tree(template):
        return tree_unflatten(template, [take(t)
                                         for t in tree_leaves(template)])

    nets = {name: tree(getattr(like, name)) for name in _NETS}
    opts = {}
    for name in _OPTS:
        opt = getattr(like, name)
        mu, nu, counts = {}, {}, []
        for keys in _adam_parts(opt):
            counts.append(int(take()))
            for moment, dst in ((opt.mu, mu), (opt.nu, nu)):
                for k in keys:
                    dst[k] = tree(moment[k])
        if len(set(counts)) != 1:
            raise ValueError(f"{path}: {name} partitions at counts {counts}")
        opts[name] = AdamState(counts[0], mu, nu, opt.split)
    emas = {}
    for name in _EMAS:
        ema = getattr(like, name)
        params = tree(ema.params)
        emas[name] = EmaState(params, float(take()), int(take()))
    step = int(take())
    if taken[0] != n:
        raise ValueError(f"{path}: {n} leaves, the state has {taken[0]}; "
                         f"configuration mismatch?")
    return TrainState(**nets, **opts, **emas, step=step)

