"""Stand-in reference modules for the checkpoint converters' tests
(tests/test_torch_convert_checkpoint.py, tests/test_torch_torch_import.py)
and chip_smoke.py's convert phase. Imports torch and numpy only.

The converters (fenerf_tpu_torch/apps/convert_checkpoint.py and the JAX
package's fenerf_tpu/apps/convert_checkpoint.py) read whole-module pickles
of the reference's generators, whose classes come from the reference tree
on --reference. `write_tree(root)` writes a small tree of that shape:

  siren/siren.py              the fields, by the reference's class names
                              (StateModule subclasses: any state_dict
                              layout, the attributes the CLIs read)
  generators/generators.py    the generator wrappers (.siren, .step and
                              optional .neural_renderer_img / _seg)
  generators/neural_rendering.py  NeuralRenderer with the attributes
                              config_from_torch_module reads
  torch_ema/__init__.py       ExponentialMovingAverage (shadow_params)

The writers invert the importers (compat/torch_import.py,
nn/neural_renderer.py): parameter trees in the JAX layout (torch tensors
or numpy arrays) become reference-layout state_dicts, and
`write_generator` pickles a generator of them (plus ema.pth / ema2.pth) as
the reference's trainer does.
"""
import contextlib
import os
import sys

import numpy as np
import torch

SIREN_PY = '''"""Stand-ins for the reference's SIREN fields."""
import torch
from torch import nn


class Node(nn.Module):
    """A container the keys' dotted paths create."""


class StateModule(nn.Module):
    """A module whose parameters are named by a reference state_dict's keys
    (in their order), holding the attributes the converters read."""

    def __init__(self, shapes, **attrs):
        super().__init__()
        for key, shape in shapes:
            *path, leaf = key.split(".")
            mod = self
            for part in path:
                if part not in mod._modules:
                    mod.add_module(part, Node())
                mod = mod._modules[part]
            mod.register_parameter(
                leaf, nn.Parameter(torch.zeros(shape), requires_grad=False))
        for k, v in attrs.items():
            setattr(self, k, v)


NAMES = (
    "TextureEmbeddingPiGAN256SEMANTICDISENTANGLE_DIM_96",
    "SIRENBASELINESEMANTICDISENTANGLE", "RESSIRENDISENTANGLE",
    "SPATIALSIRENAUGDISENTANGLE", "SPATIALSIRENBASELINE",
    "SPATIALSIRENSEMANTIC", "SPATIALSIRENSEMANTICHD", "SPATIALSIRENGRID",
)
for _name in NAMES:
    globals()[_name] = type(_name, (StateModule,), {})
'''

GENERATORS_PY = '''"""Stand-ins for the reference's generator wrappers."""
from torch import nn


class Generator(nn.Module):
    def __init__(self, siren, step=0, neural_renderer_img=None,
                 neural_renderer_seg=None):
        super().__init__()
        self.siren = siren
        self.step = step
        if neural_renderer_img is not None:
            self.neural_renderer_img = neural_renderer_img
        if neural_renderer_seg is not None:
            self.neural_renderer_seg = neural_renderer_seg


class DoubleImplicitGenerator3d(Generator):
    pass


class ImplicitGenerator3d(Generator):
    pass


class StyleGenerator3d(Generator):
    pass
'''

NEURAL_RENDERING_PY = '''"""Stand-in for the reference's NeuralRenderer (its layout only)."""
import math

from torch import nn


class Blur(nn.Module):
    pass


def _upsampler(kind):
    if kind == "nn":
        return nn.Upsample(scale_factor=2.0)
    return nn.Sequential(nn.Upsample(scale_factor=2, mode="bilinear",
                                     align_corners=False), Blur())


class NeuralRenderer(nn.Module):
    def __init__(self, n_feat=128, input_dim=128, out_dim=3,
                 final_actvn=True, min_feat=32, img_size=64, input_size=16,
                 use_rgb_skip=True, upsample_feat="nn",
                 upsample_rgb="bilinear", use_norm=False):
        super().__init__()
        self.input_dim = input_dim
        self.final_actvn = final_actvn
        self.use_rgb_skip = use_rgb_skip
        self.use_norm = use_norm
        n_blocks = int(math.log2(img_size) - math.log2(input_size))
        feat = lambda i: max(n_feat // (2 ** (i + 1)), min_feat)
        self.upsample_2 = _upsampler(upsample_feat)
        self.upsample_rgb = _upsampler(upsample_rgb)
        if n_feat != input_dim:
            self.conv_in = nn.Conv2d(input_dim, n_feat, 1)
        self.conv_layers = nn.ModuleList(
            [nn.Conv2d(n_feat if i == 0 else feat(i - 1), feat(i), 3, 1, 1)
             for i in range(n_blocks)])
        if use_rgb_skip:
            self.conv_rgb = nn.ModuleList(
                [nn.Conv2d(input_dim, out_dim, 3, 1, 1)]
                + [nn.Conv2d(feat(i), out_dim, 3, 1, 1)
                   for i in range(n_blocks)])
        else:
            self.conv_rgb = nn.Conv2d(feat(n_blocks - 1), out_dim, 1)
'''

TORCH_EMA_PY = '''"""Stand-in for torch_ema: the shadow parameters in parameter order."""


class ExponentialMovingAverage:
    def __init__(self, parameters, decay=0.999):
        self.decay = decay
        self.shadow_params = [p.clone().detach() for p in parameters]
'''

TREE = {"siren/__init__.py": "", "siren/siren.py": SIREN_PY,
        "generators/__init__.py": "", "generators/generators.py": GENERATORS_PY,
        "generators/neural_rendering.py": NEURAL_RENDERING_PY,
        "torch_ema/__init__.py": TORCH_EMA_PY}
_MODULES = ("siren", "generators", "torch_ema")


def write_tree(root: str) -> str:
    """Writes the stand-in reference tree under `root`; -> root."""
    for rel, text in TREE.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    return root


@contextlib.contextmanager
def reference_modules(root: str):
    """The stand-in tree's modules imported from `root` for the block:
    (siren, generators, neural_rendering, torch_ema). sys.path and
    sys.modules are as they were after it."""
    import importlib

    saved = {k: v for k, v in sys.modules.items()
             if k.split(".")[0] in _MODULES}
    for k in saved:
        del sys.modules[k]
    sys.path.insert(0, root)
    try:
        yield tuple(importlib.import_module(m) for m in (
            "siren.siren", "generators.generators",
            "generators.neural_rendering", "torch_ema"))
    finally:
        sys.path.remove(root)
        for k in [k for k in sys.modules if k.split(".")[0] in _MODULES]:
            del sys.modules[k]
        sys.modules.update(saved)


# ---------------------------------------------------------------------------
# Parameter trees (JAX layout) -> reference-layout state_dicts
# ---------------------------------------------------------------------------

def _cpu(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(x, np.float32))


def _lin(sd: dict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = _cpu(p["w"]).t().contiguous()
    sd[f"{prefix}.bias"] = _cpu(p["b"])


def _conv(sd: dict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = _cpu(p["w"]).permute(3, 2, 0, 1).contiguous()
    sd[f"{prefix}.bias"] = _cpu(p["b"])


def field_state_dict(params: dict, cfg, single_film: bool | None = None
                     ) -> dict:
    """A film-family field tree -> the reference SIREN's state_dict.
    single_film: the colour branch as one FiLMLayer
    (color_layer_sine.layer.*, the single-latent baselines) instead of a
    ModuleList; by default when it has one layer and one latent."""
    sd: dict = {}
    for i, p in enumerate(params["trunk"]):
        _lin(sd, f"network.{i}.layer", p)
    _lin(sd, "color_layer_linear.0", params["color_head"])
    if cfg.res_sigma:
        _lin(sd, "res_coord_layer", params["res_coord"])
        for i, p in enumerate(params["sigma_mlp"]):
            _lin(sd, f"density_layer_linear.{i}", p)
        _lin(sd, "color_layer_pre.0", params["color_pre"])
    else:
        _lin(sd, "final_layer", params["sigma_head"])
        if cfg.color_pre_dim:
            _lin(sd, "color_layer_pre.0", params["color_pre"])
    if single_film is None:
        single_film = cfg.single_latent and len(params["color"]) == 1
    if single_film:
        _lin(sd, "color_layer_sine.layer", params["color"][0])
    else:
        for i, p in enumerate(params["color"]):
            _lin(sd, f"color_layer_sine.{i}.layer", p)
    if cfg.n_labels:
        for i, p in enumerate(params["label_head"]):
            _lin(sd, f"label_layer_linear.{i}", p)
        if cfg.label_film:
            _lin(sd, "label_layer_sine.layer", params["label_film"])
    maps = ([("mapping_network", "geo_map")] if cfg.single_latent else
            [("geo_mapping_network", "geo_map"),
             ("app_mapping_network", "app_map")])
    for prefix, key in maps:
        for j, p in enumerate(params[key]):
            _lin(sd, f"{prefix}.network.{2 * j}", p)
    if cfg.grid_channels:
        sd["spatial_embeddings"] = _cpu(params["grid"])[None]
    return sd


def _mod_conv(sd: dict, prefix: str, p: dict, bias: str) -> None:
    """A modulated conv, its bias on .activate.bias ('activate', the
    styled convs) or on .bias as (1, out, 1, 1) ('plain')."""
    sd[f"{prefix}.weight"] = _cpu(p["w"]).permute(3, 2, 0, 1)[None] \
        .contiguous()
    _lin(sd, f"{prefix}.modulation", p["mod"])
    if bias == "activate":
        sd[f"{prefix}.activate.bias"] = _cpu(p["b"])
    else:
        sd[f"{prefix}.bias"] = _cpu(p["b"]).reshape(1, -1, 1, 1)


def style_generator_state_dict(params: dict, prefix: str = "") -> dict:
    """A StyleGenerator2D tree -> its reference state_dict (skip
    connections when the tree has to_rgb1)."""
    sd: dict = {}
    for i, p in enumerate(params["mapping"]):
        _lin(sd, f"{prefix}mapping_network.{i}", p)
    sd[f"{prefix}input.input"] = _cpu(params["input"])[None]
    _mod_conv(sd, f"{prefix}conv1", params["conv1"], "activate")
    for i, p in enumerate(params["convs"]):
        _mod_conv(sd, f"{prefix}convs.{i}", p, "activate")
    if "to_rgb1" in params:
        _mod_conv(sd, f"{prefix}to_rgb1.conv", params["to_rgb1"], "plain")
        for j, p in enumerate(params["to_rgbs"]):
            _mod_conv(sd, f"{prefix}to_rgbs.{j}.conv", p, "plain")
    else:
        _mod_conv(sd, f"{prefix}out_rgb.conv", params["out_rgb"], "plain")
    return sd


def grid_state_dict(params: dict) -> dict:
    """A SPATIALSIRENGRID tree -> the reference field's state_dict."""
    sd = style_generator_state_dict(params["style_gen"],
                                    "grid_latent_network.")
    for j, p in enumerate(params["map"]):
        _lin(sd, f"mapping_network.network.{2 * j}", p)
    for i, p in enumerate(params["trunk"]):
        _lin(sd, f"network.{i}.layer", p)
    _lin(sd, "final_layer", params["sigma_head"])
    _lin(sd, "color_layer_sine.layer", params["color"][0])
    _lin(sd, "color_layer_linear.0", params["color_head"])
    return sd


def neural_renderer_state_dict(params: dict) -> dict:
    """A neural-renderer tree -> NeuralRenderer's state_dict."""
    sd: dict = {}
    if "conv_in" in params:
        _conv(sd, "conv_in", params["conv_in"])
    for i, p in enumerate(params["convs"]):
        _conv(sd, f"conv_layers.{i}", p)
    if "rgbs" in params:
        for i, p in enumerate(params["rgbs"]):
            _conv(sd, f"conv_rgb.{i}", p)
    else:
        _conv(sd, "conv_rgb", params["rgb_out"])
    return sd


def discriminator_state_dict(params: dict, coord_conv: bool = True) -> dict:
    """A CCS critic's tree -> the reference's state_dict (CoordConv blocks
    nest their convs under .conv)."""
    sd: dict = {}
    sub = ".conv" if coord_conv else ""
    for i, b in enumerate(params["blocks"]):
        _conv(sd, f"layers.{i}.network.0{sub}", b["conv1"])
        _conv(sd, f"layers.{i}.network.2{sub}", b["conv2"])
        _conv(sd, f"layers.{i}.proj", b["proj"])
    for j, p in enumerate(params["from_rgb"]):
        _conv(sd, f"fromRGB.{j}.model.0", p)
    _conv(sd, "final_layer", params["final"])
    return sd


# ---------------------------------------------------------------------------
# Whole-module pickles, as the reference's trainer saves them
# ---------------------------------------------------------------------------

def field_attrs(cfg) -> dict:
    """The attributes the CLIs read off a reference field."""
    if hasattr(cfg, "grid_res"):   # the latent-grid family
        return {"z_dim": cfg.z_dim, "hidden_dim": cfg.hidden_dim,
                "output_dim": cfg.output_dim}
    if cfg.single_latent:
        return {"z_dim": cfg.z_geo_dim, "hidden_dim": cfg.hidden_dim,
                "output_dim": cfg.output_dim}
    return {"z_geo_dim": cfg.z_geo_dim, "z_app_dim": cfg.z_app_dim,
            "hidden_dim": cfg.hidden_dim, "output_dim": cfg.output_dim}


def write_generator(root: str, out_dir: str, model: str, state_dict: dict,
                    attrs: dict, step: int = 0, ema: dict | None = None,
                    ema2: dict | None = None, heads: dict | None = None,
                    wrapper: str = "DoubleImplicitGenerator3d") -> str:
    """Pickles a stand-in generator of class `wrapper` around a `model`
    field holding `state_dict`, to out_dir/generator.pth; ema / ema2 (state
    dicts of the same keys) as out_dir/ema.pth / ema2.pth through
    torch_ema. heads: {"nr_img" / "nr_seg": (state_dict, NeuralRenderer
    keyword arguments)}. The stand-in tree must be written at `root`.
    -> the generator's path."""
    os.makedirs(out_dir, exist_ok=True)
    with reference_modules(root) as (siren, generators, nr, torch_ema):
        def field(sd):
            m = getattr(siren, model)([(k, v.shape) for k, v in sd.items()],
                                      **attrs)
            with torch.no_grad():
                for k, v in m.state_dict(keep_vars=True).items():
                    v.copy_(sd[k])
            return m

        kw = {}
        for key, (sd, nr_kwargs) in (heads or {}).items():
            m = nr.NeuralRenderer(**nr_kwargs)
            m.load_state_dict(sd, strict=True)
            kw[{"nr_img": "neural_renderer_img",
                "nr_seg": "neural_renderer_seg"}[key]] = m
        gen = getattr(generators, wrapper)(field(state_dict), step, **kw)
        path = os.path.join(out_dir, "generator.pth")
        torch.save(gen, path)
        for name, sd in (("ema.pth", ema), ("ema2.pth", ema2)):
            if sd is None:
                continue
            shadow = getattr(generators, wrapper)(field(sd), step, **kw)
            torch.save(torch_ema.ExponentialMovingAverage(
                shadow.parameters()), os.path.join(out_dir, name))
    return path
