"""Generator checkpoints, backend choice, camera trajectories and film
interpolation for the port's apps (port of fenerf_tpu/apps/common.py).

The checkpoint is the JAX package's `.npz`: `__config__` JSON (model,
step, family "film", "grid" or "eg3d" (the port's own: EG3D's tri-plane
generator, nn/triplane_field.py), field_kwargs, n_params / n_ema / n_ema2)
plus `params_{i}` / `ema_{i}` / `ema2_{i}` leaves in jax.tree_util order,
and for an HD checkpoint the neural renderers' `nr_img_{i}` / `nr_seg_{i}`
leaves with `nr_img_cfg` / `nr_seg_cfg` in the JSON.
A checkpoint written by either package loads in the other, for both
families.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any

import numpy as np
import torch

from fenerf_tpu_torch.compat import jax_bridge
from fenerf_tpu_torch.models import generator as genlib
from fenerf_tpu_torch.nn import fields
from fenerf_tpu_torch.nn import latent_grid_field as lgf
from fenerf_tpu_torch.nn import triplane_field as tpf
from fenerf_tpu_torch.nn.neural_renderer import (NeuralRendererConfig,
                                                 init_neural_renderer)
from fenerf_tpu_torch.ops import film_mlp

TREES = ("params", "ema", "ema2")
NEURAL_RENDERERS = ("nr_img", "nr_seg")


def save_generator(path: str, params: Any, ema_params: Any, ema2_params: Any,
                   model: str, step: int, field_kwargs: dict | None = None,
                   neural_renderers: dict | None = None) -> None:
    """Write a generator checkpoint of either family (atomic rename).
    neural_renderers: optional {"nr_img" / "nr_seg": (params, cfg)}, the
    HD path's upsampler heads (StyleGenerator3d's neural_renderer_img /
    _seg, generators.py:914-1018), stored beside the field's trees as
    the JAX package stores them; load_neural_renderers reads them."""
    if lgf.is_grid_model(model):
        family = "grid"
    elif tpf.is_triplane_model(model):
        family = "eg3d"
    elif model in fields.VARIANTS:
        family = "film"
    else:
        raise ValueError(f"{model!r} is not a known model")
    config = {"model": model, "step": int(step), "family": family,
              "field_kwargs": field_kwargs or {}}
    arrays = {}
    trees = list(zip(TREES, (params, ema_params, ema2_params)))
    for key, (nr_params, nr_cfg) in (neural_renderers or {}).items():
        if key not in NEURAL_RENDERERS:
            raise ValueError(f"unknown neural renderer {key!r}")
        config[f"{key}_cfg"] = dataclasses.asdict(nr_cfg)
        trees.append((key, nr_params))
    for name, tree in trees:
        leaves = jax_bridge.tree_leaves(jax_bridge.to_numpy_tree(tree))
        for i, leaf in enumerate(leaves):
            arrays[f"{name}_{i}"] = leaf
        config[f"n_{name}"] = len(leaves)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, __config__=json.dumps(config), **arrays)
    os.replace(tmp, path)


def _template(cfg) -> Any:
    """The tree structure of a field's parameters, either family (tensors
    on the meta device: no memory, no draws)."""
    return genlib.init_any_field(torch.Generator(), cfg, device="meta")


def load_generator(path: str, device="cuda"):
    """-> (params, ema_params, ema2_params, cfg, config dict) as tensors on
    `device` (the card unless asked; "cpu" loads for the torch route).
    cfg is a FieldConfig (film family), a GridFieldConfig (latent-grid
    family) or a TriPlaneConfig (eg3d); config["family"] says which."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to load "
                           "the generator on the CPU")
    with np.load(path, allow_pickle=False) as data:
        config = json.loads(str(data["__config__"]))
        config.setdefault("family", "film")
        cfg = genlib.get_any_config(config["model"],
                                    **config["field_kwargs"])
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


def load_neural_renderers(path: str, device="cuda") -> dict:
    """-> {"nr_img" / "nr_seg": (params on `device`,
    NeuralRendererConfig)}, the HD heads save_generator stored (either
    package's); an empty dict when the checkpoint has none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to "
                           "load the neural renderers on the CPU")
    out = {}
    with np.load(path, allow_pickle=False) as data:
        config = json.loads(str(data["__config__"]))
        for key in NEURAL_RENDERERS:
            if f"{key}_cfg" not in config:
                continue
            cfg = NeuralRendererConfig(**config[f"{key}_cfg"])
            template = init_neural_renderer(torch.Generator(), cfg,
                                            device="meta")
            leaves = [torch.from_numpy(np.asarray(data[f"{key}_{i}"]))
                      .to(device=dev, dtype=torch.float32)
                      for i in range(config[f"n_{key}"])]
            out[key] = (jax_bridge.tree_unflatten(template, leaves), cfg)
    return out


def best_backend(cfg: Any, device, train: bool = False) -> str:
    """Backend the apps render with: 'kernel' runs the family's kernels.
    Film family: the fused field kernel on CUDA for covered variants
    (and, under FENERF_RAY_KERNELS=auto, the ray kernels), 'kernel_train'
    (fused forward and backward) with train=True
    (ops/film_mlp.py::backend_for), else 'torch'. Grid family: its field
    has no kernel and runs its torch route whatever the backend, so
    'kernel' on CUDA opens the ray kernels alone, as the JAX package's
    'pallas' does for that family; else 'torch'. route_line says which
    route each part takes."""
    if genlib.is_grid_config(cfg):
        cuda = torch.device(device).type == "cuda"
        return "kernel" if cuda and not train else "torch"
    return film_mlp.backend_for(cfg, device, train)


def visible_devices(device) -> list:
    """`device` and every other visible GPU when it is a CUDA device (the
    JAX CLIs take the whole mesh), else `device` alone."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev]
    return [dev] + [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())
                    if i != (dev.index or 0)]


def shard_devices(device, img_size: int | None = None) -> list:
    """--shard_rays' devices (visible_devices); with img_size, the strips
    must divide its rows."""
    devices = visible_devices(device)
    if img_size is not None:
        if img_size % len(devices):
            raise ValueError(f"--shard_rays: image_size {img_size} is not "
                             f"divisible by {len(devices)} devices")
        print(f"[shard_rays] {len(devices)} device(s), "
              f"{img_size // len(devices)} rows each", flush=True)
    return devices


def route_line(cfg: Any, rcfg, device) -> str:
    """The apps' route line: which route the field and the rays take (the
    grid family's field is always 'torch')."""
    field = "torch" if genlib.is_grid_config(cfg) else rcfg.backend
    route, why = genlib.ray_route(rcfg, device)
    return f"field {field}, rays {route} ({why})"


def camera_trajectory(name: str, num_frames: int, base_fov: float):
    """(t, pitch, yaw, fov) per frame of the reference's trajectories
    (render_video_interpolation_semantic.py:324-371,
    inverse_render_double_semantic.py:510-570), as python floats from
    numpy's float64 arithmetic, as the JAX package computes them."""
    two_pi = 2 * math.pi
    half_pi = math.pi / 2
    lin = np.linspace
    if name == "front":
        out = [(t, 0.2 * np.cos(t * two_pi) + half_pi,
                0.4 * np.sin(t * two_pi) + half_pi,
                base_fov + 5 + np.sin(t * two_pi) * 5)
               for t in lin(0, 1, num_frames, endpoint=True)]
    elif name == "orbit":
        out = [(t, half_pi, t * two_pi, base_fov)
               for t in lin(0, 0.5, num_frames, endpoint=True)]
    elif name == "rotation_horizontal":
        out = [(t, half_pi, half_pi + t * 0.5, base_fov)
               for t in lin(-1, 1, num_frames)]
    elif name == "rotation_linear":
        out = [(t, half_pi, half_pi + t, base_fov)
               for t in lin(-0.4, 0.4, num_frames)]
    elif name == "non_rotation":
        out = [(t, half_pi, half_pi, base_fov)
               for t in lin(0, 1, num_frames, endpoint=True)]
    elif name == "sphere":
        out = [(t, 0.2 * np.cos(t * two_pi) + half_pi,
                0.4 * np.sin(t * two_pi) + half_pi, base_fov)
               for t in lin(0, 1, num_frames, endpoint=True)]
    elif name == "inverse_sphere":
        out = [(t, 0.2 * (1 - np.cos(t * two_pi)) + half_pi,
                0.4 * np.sin(t * two_pi) + half_pi, base_fov)
               for t in lin(0, 1, num_frames)]
    elif name == "zoom":
        out = [(t, half_pi, half_pi, base_fov + np.sin(t * two_pi) * 5)
               for t in lin(0, 1, num_frames)]
    else:
        raise ValueError(f"unknown trajectory {name!r}")
    # t stays for the latent interpolation
    return [(float(t), float(p), float(y), float(f)) for t, p, y, f in out]


TRAJECTORIES = ("front", "orbit", "rotation_horizontal", "rotation_linear",
                "non_rotation", "sphere", "inverse_sphere", "zoom")


def interpolate_films(film1, film2, t: float, latent_type: str, which: str):
    """Lerp one branch's (freqs, phases) as the reference's
    DoubleFrequencyInterpolator (render_video...py:131-179): 'geo' lerps
    only the geometry branch, 'app' only appearance with t remapped to
    2t - 1, 'both' lerps both, 'non' holds endpoint 1."""
    lerp_geo = latent_type in ("geo", "both")
    lerp_app = latent_type in ("app", "both")
    if which == "geo":
        do, tt = lerp_geo, t
    else:
        do, tt = lerp_app, ((t - 0.5) * 2 if latent_type == "app" else t)
    if not do:
        return film1
    f1, p1 = film1
    f2, p2 = film2
    return (f1 * (1 - tt) + f2 * tt, p1 * (1 - tt) + p2 * tt)
