"""The port's auxiliary loss library (fenerf_tpu_torch/train/losses.py)
against fenerf_tpu/train/losses.py on seeded numpy inputs, f32, within
1e-6 (relative to each loss's scale where it exceeds 1)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fenerf_tpu.train import losses as jl
from fenerf_tpu_torch.train import losses as tl

TOL = 1e-6


def _x(shape, seed=0, scale=2.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(out, ref):
    ref = float(np.asarray(ref))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(float(out), ref, rtol=TOL,
                               atol=TOL * max(1.0, abs(ref)))


@pytest.mark.parametrize("mode", ["original", "ls", "hinge", "w"])
@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("for_d", [True, False])
def test_gan_loss_matches_jax(mode, real, for_d):
    pred = _x((4, 1, 5, 5), seed=int(real) + 2 * int(for_d))
    if mode == "hinge" and not for_d and not real:
        with pytest.raises(ValueError, match="targets real"):
            tl.gan_loss(torch.from_numpy(pred), real, mode, for_d)
        return
    ref = jl.gan_loss(jnp.asarray(pred), real, mode, for_d)
    _close(tl.gan_loss(torch.from_numpy(pred), real, mode, for_d), ref)


def test_gan_loss_unknown_mode():
    with pytest.raises(ValueError, match="unknown gan loss mode"):
        tl.gan_loss(torch.zeros(2), True, "relativistic")


@pytest.mark.parametrize("name,kw", [
    ("log_cosh_loss", {}), ("soft_bce_loss", {}),
    ("soft_bce_loss", {"smooth_factor": 0.1}), ("focal_loss", {}),
    ("focal_loss", {"gamma": 1.5, "alpha": 0.4}), ("dice_loss", {}),
])
def test_pointwise_losses_match_jax(name, kw):
    logits = _x((3, 2, 6, 6), seed=1, scale=3.0)
    target = (np.random.default_rng(2).random((3, 2, 6, 6)) > 0.5
              ).astype(np.float32)
    if name == "log_cosh_loss":
        target = _x((3, 2, 6, 6), seed=3)
    ref = getattr(jl, name)(jnp.asarray(logits), jnp.asarray(target), **kw)
    out = getattr(tl, name)(torch.from_numpy(logits),
                            torch.from_numpy(target), **kw)
    _close(out, ref)


def test_noise_regularize_matches_jax():
    noises = [_x((2, 1, s, s), seed=s, scale=1.0) for s in (32, 16, 8, 4)]
    ref = jl.noise_regularize([jnp.asarray(n) for n in noises])
    out = tl.noise_regularize([torch.from_numpy(n) for n in noises])
    _close(out, ref)
    # correlated noise costs more than white noise
    smooth = [np.repeat(np.repeat(n[:, :, ::2, ::2], 2, 2), 2, 3)
              for n in noises]
    assert float(tl.noise_regularize(
        [torch.from_numpy(n) for n in smooth])) > float(out)


def test_losses_have_gradients():
    logits = torch.from_numpy(_x((2, 1, 4, 4))).requires_grad_(True)
    target = torch.ones_like(logits)
    total = (tl.gan_loss(logits, True, "original")
             + tl.focal_loss(logits, target) + tl.dice_loss(logits, target)
             + tl.log_cosh_loss(logits, target))
    (g,) = torch.autograd.grad(total, logits)
    assert torch.isfinite(g).all() and float(g.abs().sum()) > 0
