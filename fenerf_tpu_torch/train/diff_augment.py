"""DiffAugment: differentiable GAN augmentations (port of
fenerf_tpu/train/diff_augment.py).

Reference: siren/diff_augment.py:7-108. The policy is a comma-separated
list of groups, e.g. 'color,translation,cutout'; each group is a list of
transforms applied in order. Randomness is drawn once and injected: every
transform takes its draws as an argument (`make_augment_draws` draws them
from a torch.Generator, tests replay the JAX package's), one entry per
transform in the order they apply:

  brightness, saturation, contrast   (B, 1, 1, 1) U[0, 1)
  translation                        (tx, ty) int (B,) in [-sh, sh], [-sw, sw]
  cutout                             (ox, oy) int (B,) in [0, h + 1 - ch % 2),
                                     [0, w + 1 - cw % 2)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

TRANSLATION_RATIO = 0.125
CUTOUT_RATIO = 0.5


def _brightness(x, u):
    return x + (u - 0.5)


def _saturation(x, u):
    mean = x.mean(dim=1, keepdim=True)
    return (x - mean) * (u * 2.0) + mean


def _contrast(x, u):
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean) * (u + 0.5) + mean


def _shifts(h, w, ratio=TRANSLATION_RATIO):
    return int(h * ratio + 0.5), int(w * ratio + 0.5)


def _translation(x, draw):
    """Shift each image by (tx, ty) pixels, zeros shifted in."""
    tx, ty = draw
    b, c, h, w = x.shape
    sh, sw = _shifts(h, w)
    padded = F.pad(x, (sw, sw, sh, sh))
    rows = torch.arange(h, device=x.device)[None, :] + sh + tx[:, None]
    cols = torch.arange(w, device=x.device)[None, :] + sw + ty[:, None]
    bi = torch.arange(b, device=x.device)[:, None, None]
    # (B, h, w, C): the advanced indices come first
    out = padded[bi, :, rows[:, :, None], cols[:, None, :]]
    return out.permute(0, 3, 1, 2)


def _cut_sizes(h, w, ratio=CUTOUT_RATIO):
    return int(h * ratio + 0.5), int(w * ratio + 0.5)


def _cutout(x, draw):
    """Zero a (ch, cw) rectangle centred at (ox, oy) in each image."""
    ox, oy = draw
    _, _, h, w = x.shape
    ch, cw = _cut_sizes(h, w)
    rows = torch.arange(h, device=x.device)[None, :, None]
    cols = torch.arange(w, device=x.device)[None, None, :]
    ox, oy = ox[:, None, None], oy[:, None, None]
    mask_r = (rows >= ox - ch // 2) & (rows < ox + (ch + 1) // 2)
    mask_c = (cols >= oy - cw // 2) & (cols < oy + (cw + 1) // 2)
    hole = (mask_r & mask_c)[:, None, :, :]
    return torch.where(hole, torch.zeros_like(x), x)


AUGMENT_FNS = {
    "color": (_brightness, _saturation, _contrast),
    "translation": (_translation,),
    "cutout": (_cutout,),
}


def policy_fns(policy: str) -> list:
    """The transforms of a policy string, in the order they apply."""
    if not policy:
        return []
    return [fn for group in policy.split(",")
            for fn in AUGMENT_FNS[group.strip()]]


def make_augment_draws(generator: torch.Generator, policy: str, batch: int,
                       size: tuple, device) -> list:
    """The draws of one augmentation of a (batch, C, h, w) batch."""
    h, w = size
    draws = []
    for fn in policy_fns(policy):
        if fn in (_brightness, _saturation, _contrast):
            draws.append(torch.rand((batch, 1, 1, 1), generator=generator,
                                    device=device))
        elif fn is _translation:
            sh, sw = _shifts(h, w)
            draws.append((
                torch.randint(-sh, sh + 1, (batch,), generator=generator,
                              device=device),
                torch.randint(-sw, sw + 1, (batch,), generator=generator,
                              device=device)))
        else:
            ch, cw = _cut_sizes(h, w)
            draws.append((
                torch.randint(0, h + (1 - ch % 2), (batch,),
                              generator=generator, device=device),
                torch.randint(0, w + (1 - cw % 2), (batch,),
                              generator=generator, device=device)))
    return draws


def diff_augment(x: torch.Tensor, policy: str, draws: list) -> torch.Tensor:
    """Apply `policy` to (B, C, H, W) images with its draws
    (make_augment_draws)."""
    fns = policy_fns(policy)
    if len(draws) != len(fns):
        raise ValueError(f"policy {policy!r} takes {len(fns)} draws, got "
                         f"{len(draws)}")
    for fn, d in zip(fns, draws):
        x = fn(x, d)
    return x
