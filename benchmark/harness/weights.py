"""Random weights made by the benchmark from the seed, on the device, in two
large draws (one uniform, one normal), carved into the program's parameter
trees (linear weights (in, out), convolution weights HWIO).

The distributions are the published initialisations: pi-GAN's SIREN and
FiLM layers, kaiming-normal (LeakyReLU 0.2) mapping networks with the last
layer x0.25, a normal texture grid x0.1, the CoordConv critics' kaiming /
torch-default convolutions and StyleGAN2's equalized layers. The program
and the reference both receive these tensors; neither makes its own.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Spec(NamedTuple):
    shape: tuple
    kind: str            # "uniform" (+-scale), "normal" (x scale), "const"
    scale: float = 1.0


def _u(shape, bound):
    return Spec(tuple(shape), "uniform", bound)


def _n(shape, std):
    return Spec(tuple(shape), "normal", std)


def _c(shape, value):
    return Spec(tuple(shape), "const", value)


def _linear(fan_in, fan_out, w: Spec):
    return {"w": w, "b": _u((fan_out,), 1.0 / math.sqrt(fan_in))}


def _siren(fan_in, fan_out):
    return _linear(fan_in, fan_out,
                   _u((fan_in, fan_out), math.sqrt(6.0 / fan_in) / 25.0))


def _kaiming(fan_in, fan_out, scale=1.0):
    std = math.sqrt(2.0 / (1.0 + 0.2 ** 2) / fan_in) * scale
    return _linear(fan_in, fan_out, _n((fan_in, fan_out), std))


def _mapping(z_dim, hidden, out_dim, n_blocks):
    dims = [(z_dim, hidden)] + [(hidden, hidden)] * n_blocks \
        + [(hidden, out_dim)]
    return [_kaiming(i, o, 0.25 if k == len(dims) - 1 else 1.0)
            for k, (i, o) in enumerate(dims)]


def film_field(c: dict) -> dict:
    """TextureEmbeddingPiGAN256SEMANTICDISENTANGLE_DIM_96's tree."""
    h = c["hidden_dim"]
    color_in = 3 + c["grid_channels"] + h
    trunk = [_linear(3, h, _u((3, h), 1.0 / 3.0))] + [
        _siren(h, h) for _ in range(c["trunk_layers"] - 1)]
    r = c["grid_resolution"]
    return {
        "trunk": trunk,
        "color": [_siren(color_in if i == 0 else h, h)
                  for i in range(c["color_layers"])],
        "color_head": _siren(h, 3),
        "sigma_head": _siren(h, 1),
        "label_head": [_siren(h, h) for _ in range(c["label_hidden_layers"])]
        + [_siren(h, c["n_labels"])],
        "geo_map": _mapping(c["z_geo_dim"], c["map_hidden_dim"],
                            c["trunk_layers"] * h * 2, 3),
        "app_map": _mapping(c["z_app_dim"], c["map_hidden_dim"],
                            c["color_layers"] * h * 2, 3),
        "grid": _n((c["grid_channels"], r, r, r), c["grid_init_scale"]),
    }


def _equal_linear(i, o, lr_mul=1.0, bias=0.0):
    return {"w": _n((i, o), 1.0 / lr_mul), "b": _c((o,), bias)}


def _mod_conv(cin, cout, k, z_dim):
    return {"w": _n((k, k, cin, cout), 1.0),
            "mod": _equal_linear(z_dim, cin, bias=1.0),
            "b": _c((cout,), 0.0)}


def grid_field(c: dict) -> dict:
    """SPATIALSIRENGRID's tree (the StyleGAN2 plane without skips)."""
    h, z, ch = c["hidden_dim"], c["z_dim"], c["ch_max"]
    convs, res = [], 4
    while res < c["grid_res"]:
        res *= 2
        convs += [_mod_conv(ch, ch, 3, z), _mod_conv(ch, ch, 3, z)]
    style = {
        "mapping": [_equal_linear(z, z, lr_mul=0.01) for _ in range(3)],
        "input": _n((ch, 4, 4), 1.0),
        "conv1": _mod_conv(ch, ch, 3, z),
        "convs": convs,
        "out_rgb": _mod_conv(ch, c["grid_ch"], 1, z),
    }
    n_film = c["trunk_layers"] + 1
    return {
        "style_gen": style,
        "map": _mapping(c["grid_ch"], c["map_hidden_dim"], n_film * h * 2, 1),
        "trunk": [_linear(3, h, _u((3, h), 1.0 / 3.0))]
        + [_siren(h, h) for _ in range(c["trunk_layers"] - 1)],
        "sigma_head": _siren(h, 1),
        "color": [_siren(h + 3, h)],
        "color_head": _siren(h, 3),
    }


CRITIC_CHANNELS = (32, 64, 128, 256, 400, 400, 400, 400)


def _conv(cin, cout, k, kaiming: bool):
    fan_in = cin * k * k
    if kaiming:
        w = _n((k, k, cin, cout), math.sqrt(2.0 / 1.04 / fan_in))
    else:
        w = _u((k, k, cin, cout), 1.0 / math.sqrt(fan_in))
    return {"w": w, "b": _u((cout,), 1.0 / math.sqrt(fan_in))}


def critic(input_dim: int, head_dim: int) -> dict:
    """The progressive CoordConv critic's tree (7 residual blocks)."""
    ch = CRITIC_CHANNELS
    blocks = [{"conv1": _conv(ch[i] + 2, ch[i + 1], 3, True),
               "conv2": _conv(ch[i + 1] + 2, ch[i + 1], 3, True),
               "proj": _conv(ch[i], ch[i + 1], 1, False)}
              for i in range(len(ch) - 1)]
    return {"blocks": blocks,
            "from_rgb": [_conv(input_dim, c, 1, False) for c in ch],
            "final": _conv(400, head_dim, 2, False)}


def _specs(tree, out):
    if isinstance(tree, Spec):
        out.append(tree)
    elif isinstance(tree, dict):
        for k in tree:
            _specs(tree[k], out)
    else:
        for t in tree:
            _specs(t, out)
    return out


def materialize(tree, seed: int, device) -> dict:
    """The tree's tensors, every uniform leaf carved from one torch.rand and
    every normal leaf from one torch.randn on `device`."""
    specs = _specs(tree, [])
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    size = lambda kind: sum(math.prod(s.shape) for s in specs
                            if s.kind == kind)
    pools = {"uniform": torch.rand(size("uniform"), generator=gen,
                                   device=device) * 2.0 - 1.0,
             "normal": torch.randn(size("normal"), generator=gen,
                                   device=device)}
    at = {"uniform": 0, "normal": 0}

    def build(t):
        if isinstance(t, Spec):
            if t.kind == "const":
                return torch.full(t.shape, t.scale, device=device)
            n = math.prod(t.shape)
            flat = pools[t.kind][at[t.kind]:at[t.kind] + n]
            at[t.kind] += n
            return (flat * t.scale).reshape(t.shape)
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        return [build(v) for v in t]

    return build(tree)
