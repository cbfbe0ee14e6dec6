"""Auxiliary loss library (port of fenerf_tpu/train/losses.py).

Reference: losses.py:8-118 (SPADE-style GANLoss; the hinge variant is the
trainer's commented-out option 2, train_double_latent_semantic.py:383-384)
and generators/losses.py:6-306 (LogCosh / soft-BCE / Focal / Dice /
noise_regularize: shipped but unused by the main pipelines, kept for
completeness).

All pure functions over logits / targets; the non-saturating softplus loss
the trainer uses lives in train/loop.py.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _bce_with_logits(logits, target):
    """max(x, 0) - x t + log1p(exp(-|x|)), elementwise."""
    return (torch.clamp(logits, min=0) - logits * target
            + torch.log1p(torch.exp(-torch.abs(logits))))


def gan_loss(pred: torch.Tensor, target_is_real: bool, mode: str = "hinge",
             for_discriminator: bool = True) -> torch.Tensor:
    """SPADE GANLoss (losses.py:8-118): 'original' (BCE-with-logits),
    'ls' (MSE), 'hinge', 'w' (Wasserstein)."""
    if mode == "original":
        target = torch.ones_like(pred) if target_is_real \
            else torch.zeros_like(pred)
        return torch.mean(_bce_with_logits(pred, target))
    if mode == "ls":
        target = 1.0 if target_is_real else 0.0
        return torch.mean((pred - target) ** 2)
    if mode == "hinge":
        if for_discriminator:
            if target_is_real:
                return -torch.mean(torch.clamp(pred - 1.0, max=0.0))
            return -torch.mean(torch.clamp(-pred - 1.0, max=0.0))
        if not target_is_real:
            raise ValueError("the generator's hinge loss targets real")
        return -torch.mean(pred)
    if mode == "w":
        return -torch.mean(pred) if target_is_real else torch.mean(pred)
    raise ValueError(f"unknown gan loss mode {mode!r}")


def log_cosh_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """generators/losses.py LogCosh: numerically stable log(cosh(x))."""
    x = pred - target
    return torch.mean(x + F.softplus(-2.0 * x) - torch.log(
        torch.tensor(2.0, dtype=x.dtype, device=x.device)))


def soft_bce_loss(logits: torch.Tensor, target: torch.Tensor,
                  smooth_factor: float = 0.0) -> torch.Tensor:
    """BCE-with-logits with label smoothing (generators/losses.py SoftBCE)."""
    if smooth_factor:
        target = target * (1.0 - smooth_factor) + 0.5 * smooth_factor
    return torch.mean(_bce_with_logits(logits, target))


def focal_loss(logits: torch.Tensor, target: torch.Tensor, gamma: float = 2.0,
               alpha: float = 0.25) -> torch.Tensor:
    """Binary focal loss (generators/losses.py Focal)."""
    p = torch.sigmoid(logits)
    ce = _bce_with_logits(logits, target)
    p_t = p * target + (1 - p) * (1 - target)
    a_t = alpha * target + (1 - alpha) * (1 - target)
    return torch.mean(a_t * (1 - p_t) ** gamma * ce)


def dice_loss(logits: torch.Tensor, target: torch.Tensor,
              eps: float = 1e-7) -> torch.Tensor:
    """Soft dice over the spatial axes (generators/losses.py Dice)."""
    p = torch.sigmoid(logits)
    dims = tuple(range(2, logits.ndim))
    inter = torch.sum(p * target, dim=dims)
    card = torch.sum(p + target, dim=dims)
    return torch.mean(1.0 - 2.0 * inter / (card + eps))


def noise_regularize(noises: list[torch.Tensor]) -> torch.Tensor:
    """StyleGAN2 noise auto-correlation regularizer
    (generators/losses.py:noise_regularize): penalize the spatial
    correlation of each layer's (N, C, H, W) noise map at every octave."""
    loss = 0.0
    for n in noises:
        while True:
            size = n.shape[2]
            loss = loss + torch.mean(
                n * torch.roll(n, 1, dims=3)) ** 2 + torch.mean(
                n * torch.roll(n, 1, dims=2)) ** 2
            if size <= 8:
                break
            n = n.reshape(n.shape[0], 1, size // 2, 2, size // 2, 2)
            n = n.mean(dim=(3, 5))
    return loss
