"""pi-GAN / FENeRF parameter initializers (port of fenerf_tpu/nn/init.py).

Every initializer draws from an explicit torch.Generator onto an explicit
device. Linear weights keep the JAX package's (fan_in, fan_out) layout so
forward is x @ w + b and checkpoints copy across without transposes.
"""
from __future__ import annotations

import math

import torch


def uniform(gen: torch.Generator, shape, bound: float, device,
            dtype=torch.float32) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device, dtype=dtype)
    return (u * 2.0 - 1.0) * bound


def normal(gen: torch.Generator, shape, device,
           dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


def frequency_weight(gen, fan_in, fan_out, device, freq=25.0):
    """pi-GAN SIREN hidden-layer weight: U(+-sqrt(6/fan_in)/freq)."""
    return uniform(gen, (fan_in, fan_out), math.sqrt(6.0 / fan_in) / freq,
                   device)


def first_layer_film_weight(gen, fan_in, fan_out, device):
    """First FiLM layer: U(+-1/fan_in)."""
    return uniform(gen, (fan_in, fan_out), 1.0 / fan_in, device)


def modified_first_weight(gen, fan_in, fan_out, device):
    """Embedding-grid variants: U(+-1/3) regardless of true fan-in."""
    return uniform(gen, (fan_in, fan_out), 1.0 / 3.0, device)


def kaiming_leaky_weight(gen, fan_in, fan_out, device, a=0.2):
    """kaiming_normal(fan_in, leaky_relu a): N(0, sqrt(2/(1+a^2)/fan_in))."""
    std = math.sqrt(2.0 / (1.0 + a * a) / fan_in)
    return normal(gen, (fan_in, fan_out), device) * std


def torch_default_weight(gen, fan_in, fan_out, device):
    """torch nn.Linear default: kaiming_uniform(a=sqrt(5)) == U(+-1/sqrt(fan_in))."""
    return uniform(gen, (fan_in, fan_out), 1.0 / math.sqrt(fan_in), device)


def linear(gen, fan_in, fan_out, weight_init, device) -> dict:
    """{'w': (in, out), 'b': (out,)} with the torch-default bias."""
    return {
        "w": weight_init(gen, fan_in, fan_out, device),
        "b": uniform(gen, (fan_out,), 1.0 / math.sqrt(fan_in), device),
    }


def conv2d(gen, in_ch, out_ch, ksize, device) -> dict:
    """Conv params {'w': (kh, kw, in, out) HWIO, 'b': (out,)} with torch's
    default init: U(+-1/sqrt(fan_in)) for both."""
    bound = 1.0 / math.sqrt(in_ch * ksize * ksize)
    return {"w": uniform(gen, (ksize, ksize, in_ch, out_ch), bound, device),
            "b": uniform(gen, (out_ch,), bound, device)}


def conv2d_kaiming_leaky(gen, in_ch, out_ch, ksize, device, a=0.2) -> dict:
    """HWIO conv with kaiming_normal(fan_in, leaky_relu a) weights and the
    torch-default bias."""
    fan_in = in_ch * ksize * ksize
    std = math.sqrt(2.0 / (1.0 + a * a) / fan_in)
    return {"w": normal(gen, (ksize, ksize, in_ch, out_ch), device) * std,
            "b": uniform(gen, (out_ch,), 1.0 / math.sqrt(fan_in), device)}
