"""Generator checkpoints and backend choice for the port's apps.

The checkpoint is the JAX package's `.npz` (fenerf_tpu/apps/common.py):
`__config__` JSON (model, step, family, field_kwargs, n_params / n_ema /
n_ema2) plus `params_{i}` / `ema_{i}` / `ema2_{i}` leaves in jax.tree_util
order. A checkpoint written by either package loads in the other.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from fenerf_tpu_torch.compat import jax_bridge
from fenerf_tpu_torch.nn import fields
from fenerf_tpu_torch.ops import film_mlp

TREES = ("params", "ema", "ema2")


def save_generator(path: str, params: Any, ema_params: Any, ema2_params: Any,
                   model: str, step: int,
                   field_kwargs: dict | None = None) -> None:
    """Write a film-family generator checkpoint (atomic rename)."""
    if model not in fields.VARIANTS:
        raise ValueError(f"{model!r} is not a film-family model")
    config = {"model": model, "step": int(step), "family": "film",
              "field_kwargs": field_kwargs or {}}
    arrays = {}
    for name, tree in zip(TREES, (params, ema_params, ema2_params)):
        leaves = jax_bridge.tree_leaves(jax_bridge.to_numpy_tree(tree))
        for i, leaf in enumerate(leaves):
            arrays[f"{name}_{i}"] = leaf
        config[f"n_{name}"] = len(leaves)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, __config__=json.dumps(config), **arrays)
    os.replace(tmp, path)


def _template(cfg: fields.FieldConfig) -> Any:
    """The tree structure of a field's parameters (scalar placeholders on
    the meta device: no memory, no draws)."""
    gen = torch.Generator()
    return fields.init_field(gen, cfg, device="meta")


def load_generator(path: str, device="cuda"):
    """-> (params, ema_params, ema2_params, cfg, config dict) as tensors on
    `device` (the card unless asked; "cpu" loads for the torch route).
    Film family only."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to load "
                           "the generator on the CPU")
    with np.load(path, allow_pickle=False) as data:
        config = json.loads(str(data["__config__"]))
        config.setdefault("family", "film")
        if config["family"] != "film":
            raise NotImplementedError(
                f"{config['family']}-family checkpoints are not ported yet")
        cfg = fields.get_config(config["model"], **config["field_kwargs"])
        template = _template(cfg)
        n_template = len(jax_bridge.tree_leaves(template))

        def tree(name):
            n = config[f"n_{name}"]
            if n != n_template:
                raise ValueError(f"checkpoint has {n} {name} leaves, "
                                 f"{cfg.name} has {n_template}")
            leaves = [torch.from_numpy(np.asarray(data[f"{name}_{i}"]))
                      .to(device=dev, dtype=torch.float32)
                      for i in range(n)]
            return jax_bridge.tree_unflatten(template, leaves)

        return tree("params"), tree("ema"), tree("ema2"), cfg, config


def best_backend(cfg: Any, device, train: bool = False) -> str:
    """Backend the apps render with: the fused kernel on CUDA for covered
    variants, 'kernel_train' (fused forward and backward) with train=True
    (ops/film_mlp.py::backend_for), else 'torch'."""
    return film_mlp.backend_for(cfg, device, train)
