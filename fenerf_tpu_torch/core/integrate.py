"""Alpha compositing and hierarchical importance sampling (port of
fenerf_tpu/core/integrate.py: integrate, integrate_weights, apply_fill,
midpoints, sample_pdf with the PICK_IMPL="reduce" semantics, and
composite_merged_nosort). Noise and uniforms are passed in as tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Integrated(NamedTuple):
    comp: torch.Tensor         # (..., R, C) composited channels
    depth: torch.Tensor        # (..., R)
    weights: torch.Tensor      # (..., R, S)
    weights_sum: torch.Tensor  # (..., R)


def _act_sigma(sigmas: torch.Tensor, clamp_mode: str) -> torch.Tensor:
    if clamp_mode == "softplus":
        return torch.nn.functional.softplus(sigmas)
    if clamp_mode == "relu":
        return torch.relu(sigmas)
    raise ValueError(f"unknown clamp_mode {clamp_mode!r}")


def _composite_weights(sigmas, z_vals, clamp_mode: str) -> torch.Tensor:
    """Terminal-1e10 deltas, alpha = 1 - exp(-delta * act(sigma)),
    exclusive transmittance cumprod of (1 - alpha + 1e-10)."""
    deltas = z_vals[..., 1:] - z_vals[..., :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[..., :1], 1e10)],
                       dim=-1)
    alphas = 1.0 - torch.exp(-deltas * _act_sigma(sigmas, clamp_mode))
    trans = torch.cumprod(1.0 - alphas + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]],
                      dim=-1)
    return alphas * trans


def integrate(rgb_sigma, z_vals, noise=None, noise_std=0.5,
              clamp_mode: str = "relu", last_back: bool = False,
              white_back: bool = False, black_back: bool = False
              ) -> Integrated:
    """NeRF volume rendering of (..., R, S, C+1) samples (last channel
    sigma); `noise` is unscaled standard normals of the sigma shape."""
    channels = rgb_sigma[..., :-1]
    sigmas = rgb_sigma[..., -1]
    if noise is not None:
        sigmas = sigmas + noise * noise_std
    weights = _composite_weights(sigmas, z_vals, clamp_mode)
    weights_sum = weights.sum(dim=-1)
    if last_back:
        weights = weights.clone()
        weights[..., -1] += 1.0 - weights_sum
    comp = torch.sum(weights[..., None] * channels, dim=-2)
    depth = torch.sum(weights * z_vals, dim=-1)
    if white_back:
        comp = comp + (1.0 - weights_sum)[..., None]
    if black_back:
        comp = comp - (1.0 - weights_sum)[..., None]
    return Integrated(comp, depth, weights, weights_sum)


def integrate_weights(sigmas, z_vals, noise=None, noise_std=0.5,
                      clamp_mode: str = "relu") -> torch.Tensor:
    """Compositing weights only (the hierarchical proposal pass)."""
    if noise is not None:
        sigmas = sigmas + noise * noise_std
    return _composite_weights(sigmas, z_vals, clamp_mode)


_FILL_VALUES = {"white": 1.0, "black": 0.0, "grey": 0.5, "light_grey": 0.81}


def apply_fill(comp: torch.Tensor, weights_sum: torch.Tensor,
               fill_mode: str | None, fill_color: str = "black"
               ) -> torch.Tensor:
    """Low-opacity pixel painting. 'seg_padding_background' /
    'eval_seg_padding_background' prepend a zero background-label channel
    and paint pixels with opacity < 0.9 as [1, fill, fill, ...];
    'eval_white_back' paints them white; 'debug' / 'weight_debug' as
    [1, 0, ...]."""
    if fill_mode is None or fill_mode == "weight":
        return comp
    low = (weights_sum < 0.9)[..., None]
    if fill_mode in ("seg_padding_background", "eval_seg_padding_background"):
        comp = torch.cat([torch.zeros_like(comp[..., :1]), comp], dim=-1)
        fill = torch.full_like(comp[..., 1:], _FILL_VALUES[fill_color])
        target = torch.cat([torch.ones_like(comp[..., :1]), fill], dim=-1)
        return torch.where(low, target, comp)
    if fill_mode == "eval_white_back":
        return torch.where(low, torch.ones_like(comp), comp)
    if fill_mode in ("debug", "weight_debug"):
        target = torch.cat([torch.ones_like(comp[..., :1]),
                            torch.zeros_like(comp[..., 1:])], dim=-1)
        return torch.where(low, target, comp)
    raise ValueError(f"unknown fill_mode {fill_mode!r}")


def midpoints(z_vals: torch.Tensor) -> torch.Tensor:
    """(..., S) -> (..., S-1) interval midpoints."""
    return 0.5 * (z_vals[..., :-1] + z_vals[..., 1:])


def _pick_rows(idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """vals[..., idx] per row as an equality-mask select + sum (exact: one
    nonzero term). idx (..., K) in [0, M); vals (..., M) -> (..., K)."""
    iota = torch.arange(vals.shape[-1], device=vals.device)
    hit = idx[..., :, None] == iota
    return torch.where(hit, vals[..., None, :],
                       torch.zeros((), dtype=vals.dtype,
                                   device=vals.device)).sum(-1)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_importance: int,
               u: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inverse-CDF importance sampling at the given uniforms
    u (..., n_importance); bins (..., M), weights (..., M-1). searchsorted
    (side='left') as a comparison count."""
    w = weights + eps
    pdf = w / torch.sum(w, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(bins[..., :1]), cdf], dim=-1)
    u_shape = weights.shape[:-1] + (n_importance,)
    if tuple(u.shape) != tuple(u_shape):
        raise ValueError(f"u has shape {tuple(u.shape)}, expected {u_shape}")
    inds = (cdf[..., None, :] < u[..., :, None]).to(torch.int64).sum(-1)
    m = weights.shape[-1]
    below = (inds - 1).clamp(0, m)
    above = inds.clamp(0, m)
    cdf_below = _pick_rows(below, cdf)
    cdf_above = _pick_rows(above, cdf)
    bins_below = _pick_rows(below, bins)
    bins_above = _pick_rows(above, bins)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bins_below + (u - cdf_below) / denom * (bins_above - bins_below)


def _before_mask(all_z: torch.Tensor) -> torch.Tensor:
    """before[i, j]: sample j precedes sample i in the stable sort of the
    per-ray concat (z_j < z_i, or equal z and j < i)."""
    s = all_z.shape[-1]
    zi = all_z[..., :, None]
    zj = all_z[..., None, :]
    ar = torch.arange(s, device=all_z.device)
    j_lt_i = ar[None, :] < ar[:, None]
    return (zj < zi) | ((zj == zi) & j_lt_i)


def composite_merged_nosort(fine_out, coarse_out, fine_z, coarse_z,
                            noise=None, noise_std=0.5,
                            clamp_mode: str = "relu", last_back: bool = False,
                            white_back: bool = False,
                            black_back: bool = False) -> Integrated:
    """Depth-sorted compositing of [fine | coarse] samples without
    permuting them: transmittance is a masked product over each sample's
    predecessors, its delta the z of the sample ranked next. `noise` is
    indexed by sorted position."""
    s = fine_z.shape[-1] + coarse_z.shape[-1]
    all_z = torch.cat([fine_z, coarse_z], dim=-1)
    all_out = torch.cat([fine_out, coarse_out], dim=-2)
    before = _before_mask(all_z)
    rank = before.sum(-1)
    sigma = all_out[..., -1]
    if noise is not None:
        sigma = sigma + _pick_rows(rank, noise) * noise_std
    act = _act_sigma(sigma, clamp_mode)
    is_next = rank[..., None, :] == rank[..., :, None] + 1
    zero = torch.zeros((), dtype=all_z.dtype, device=all_z.device)
    next_z = torch.where(is_next, all_z[..., None, :], zero).sum(-1)
    deltas = torch.where(rank == s - 1,
                         torch.full((), 1e10, dtype=all_z.dtype,
                                    device=all_z.device),
                         next_z - all_z)
    alphas = 1.0 - torch.exp(-deltas * act)
    om = 1.0 - alphas + 1e-10
    one = torch.ones((), dtype=om.dtype, device=om.device)
    trans = torch.where(before, om[..., None, :], one).prod(-1)
    w = alphas * trans
    weights_sum = w.sum(-1)
    if last_back:
        w = w + torch.where(rank == s - 1, (1.0 - weights_sum)[..., None],
                            zero)
    comp = torch.sum(w[..., None] * all_out[..., :-1], dim=-2)
    depth = torch.sum(w * all_z, dim=-1)
    if white_back:
        comp = comp + (1.0 - weights_sum)[..., None]
    if black_back:
        comp = comp - (1.0 - weights_sum)[..., None]
    return Integrated(comp, depth, w, weights_sum)


def mip_march(colors: torch.Tensor, sigmas: torch.Tensor,
              z_vals: torch.Tensor):
    """EG3D's MipRayMarcher2 on depth-sorted samples: colours (..., S, C),
    raw densities and depths (..., S) taken at the S - 1 interval
    midpoints, density softplus(sigma - 1), alpha = 1 - exp(-density *
    delta), transmittance from (1 - alpha + 1e-10). The depth is the
    weighted midpoint over the weights' sum (a NaN reads +inf), clamped to
    the least and greatest depth of the call. -> (comp (..., C) before the
    x 2 - 1, depth (...), weights (..., S - 1))."""
    mid = lambda t: 0.5 * (t[..., :-1] + t[..., 1:])
    deltas = z_vals[..., 1:] - z_vals[..., :-1]
    colors_mid = (colors[..., :-1, :] + colors[..., 1:, :]) / 2
    density = torch.nn.functional.softplus(mid(sigmas) - 1)
    alpha = 1 - torch.exp(-density * deltas)
    shifted = torch.cat([torch.ones_like(alpha[..., :1]),
                         1 - alpha + 1e-10], dim=-1)
    weights = alpha * torch.cumprod(shifted, dim=-1)[..., :-1]
    comp = torch.sum(weights[..., None] * colors_mid, dim=-2)
    depth = torch.sum(weights * mid(z_vals), dim=-1) / weights.sum(-1)
    depth = torch.nan_to_num(depth, float("inf"))
    depth = torch.clamp(depth, torch.min(z_vals), torch.max(z_vals))
    return comp, depth, weights


def smooth_importance_weights(weights: torch.Tensor) -> torch.Tensor:
    """EG3D's sample_importance smoothing of the proposal weights (..., L):
    max-pool (2, stride 1, pad 1), avg-pool (2, stride 1), plus 0.01.
    -> (..., L)."""
    shape = weights.shape
    w = weights.reshape(-1, 1, shape[-1])
    w = torch.nn.functional.max_pool1d(w, 2, 1, padding=1)
    w = torch.nn.functional.avg_pool1d(w, 2, 1)
    return w.reshape(shape) + 0.01
