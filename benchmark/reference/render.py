"""Plain volume rendering of a per-point field, after pi-GAN and FENeRF's
generators: pixel rays, a camera on the unit sphere, stratified samples,
a coarse pass, inverse-CDF resampling, a fine pass, the depth-sorted merge
of both sample sets, alpha compositing and the low-opacity fill.

`render(field, rc, draws, ...)` takes every random number of the render in
`Draws` and returns pixels (B, C, H, W) in [-1, 1], depth (B, H, W),
opacity (B, H, W) and the camera's (pitch, yaw) (B, 2). No gradient flows
through the proposal (coarse weights -> resampled depths), as in the
published generator.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.utils.checkpoint


class RenderSpec(NamedTuple):
    img_size: int
    num_steps: int
    fov: float = 12.0
    ray_start: float = 0.88
    ray_end: float = 1.12
    h_stddev: float = 0.3
    v_stddev: float = 0.155
    h_mean: float = math.pi / 2
    v_mean: float = math.pi / 2
    fill_mode: str | None = None


class Draws(NamedTuple):
    """One render's random numbers: U[0, 1) jitter and importance uniforms
    (B, R, S), standard-normal camera draws (B, 1) (None: a fixed camera)."""
    jitter: torch.Tensor
    u: torch.Tensor
    cam_h: torch.Tensor | None = None
    cam_v: torch.Tensor | None = None


def _unit(v):
    return v / v.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def camera_rays(rc: RenderSpec, batch: int, draws: Draws, camera=None,
                device="cpu"):
    """World-space ray origins and directions (B, R, 3), stratified depths
    (B, R, S) and the camera angles (B, 2) = (pitch, yaw)."""
    n, s = rc.img_size, rc.num_steps
    fov = rc.fov
    if camera is not None:
        pitch, yaw, fov = camera
        theta = torch.full((batch, 1), float(yaw), device=device)
        phi = torch.full((batch, 1), float(pitch), device=device)
    else:
        theta = draws.cam_h * rc.h_stddev + rc.h_mean
        phi = draws.cam_v * rc.v_stddev + rc.v_mean
    phi = phi.clamp(1e-5, math.pi - 1e-5)
    xs = torch.linspace(-1.0, 1.0, n, device=device)
    ys = torch.linspace(1.0, -1.0, n, device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    zz = torch.full_like(xx, -1.0 / math.tan(math.radians(fov) / 2.0))
    d_cam = _unit(torch.stack([xx, yy, zz], -1).reshape(-1, 3))

    origin = torch.cat([torch.sin(phi) * torch.cos(theta), torch.cos(phi),
                        torch.sin(phi) * torch.sin(theta)], -1)
    forward = _unit(-origin)
    up = torch.tensor([0.0, 1.0, 0.0], device=device).expand_as(forward)
    left = _unit(torch.linalg.cross(up, forward, dim=-1))
    up = _unit(torch.linalg.cross(forward, left, dim=-1))
    rot = torch.stack([-left, up, -forward], dim=-1)          # (B, 3, 3)
    dirs = torch.einsum("bij,rj->bri", rot, d_cam)
    origins = origin[:, None, :].expand_as(dirs)

    z = torch.linspace(rc.ray_start, rc.ray_end, s, device=device)
    z = z + (draws.jitter - 0.5) * (z[1] - z[0])
    return origins, dirs, z, torch.cat([phi, theta], -1)


def alpha_weights(sigma, z):
    """Compositing weights of sorted samples: ReLU densities, the last
    interval 1e10 long, transmittance from (1 - alpha + 1e-10)."""
    deltas = torch.cat([z[..., 1:] - z[..., :-1],
                        torch.full_like(z[..., :1], 1e10)], -1)
    alpha = 1.0 - torch.exp(-deltas * torch.relu(sigma))
    trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    return alpha * trans


def sample_pdf(bins, weights, u, eps=1e-5):
    """Inverse-CDF samples at uniforms u (..., K) of the piecewise-constant
    density `weights` (..., M-1) over `bins` (..., M)."""
    w = weights + eps
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous())
    m = weights.shape[-1]
    below = (inds - 1).clamp(0, m)
    above = inds.clamp(0, m)
    cb, ca = cdf.gather(-1, below), cdf.gather(-1, above)
    bb, ba = bins.gather(-1, below), bins.gather(-1, above)
    denom = ca - cb
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bb + (u - cb) / denom * (ba - bb)


def fill(comp, opacity, mode):
    """Pixels under 0.9 opacity painted: a background label (1 in a new
    first channel, 0 elsewhere) or white."""
    if mode is None:
        return comp
    low = (opacity < 0.9)[..., None]
    if mode in ("seg_padding_background", "eval_seg_padding_background"):
        comp = torch.cat([torch.zeros_like(comp[..., :1]), comp], -1)
        target = torch.zeros_like(comp)
        target[..., 0] = 1.0
        return torch.where(low, target, comp)
    if mode == "eval_white_back":
        return torch.where(low, torch.ones_like(comp), comp)
    raise ValueError(f"unknown fill {mode!r}")


def shade(field: Callable, rc: RenderSpec, origins, dirs, z, u,
          checkpoint: bool = False):
    """Coarse pass, resample, fine pass and the sorted composite of one
    block of rays. field(points (B, N, 3), dirs (B, N, 3)) -> (B, N, C+1),
    the last channel the density. Returns comp (B, R, C), depth and
    opacity (B, R)."""
    b, r, s = z.shape
    run = field
    if checkpoint and torch.is_grad_enabled():
        run = lambda p, d: torch.utils.checkpoint.checkpoint(
            field, p, d, use_reentrant=False)

    def evaluate(zs):
        pts = origins[:, :, None] + dirs[:, :, None] * zs[..., None]
        drs = dirs[:, :, None].expand_as(pts)
        out = run(pts.reshape(b, -1, 3), drs.reshape(b, -1, 3))
        return out.reshape(b, r, zs.shape[-1], -1)

    coarse = evaluate(z)
    with torch.no_grad():
        w = alpha_weights(coarse[..., -1], z) + 1e-5
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        fine_z = sample_pdf(mids, w[..., 1:-1], u)
    fine = evaluate(fine_z)
    all_z, order = torch.sort(torch.cat([fine_z, z], -1), dim=-1,
                              stable=True)
    out = torch.cat([fine, coarse], -2)
    out = out.gather(-2, order[..., None].expand_as(out))
    w = alpha_weights(out[..., -1], all_z)
    comp = (w[..., None] * out[..., :-1]).sum(-2)
    return comp, (w * all_z).sum(-1), w.sum(-1)


def render(field: Callable, rc: RenderSpec, draws: Draws, batch: int,
           camera=None, ray_chunk: int = 0, checkpoint: bool = False,
           device="cpu") -> dict:
    """A batch of images: rays in blocks of `ray_chunk` (0: all at once),
    each block's field evaluations recomputed in the backward when
    `checkpoint`."""
    origins, dirs, z, position = camera_rays(rc, batch, draws, camera,
                                             device)
    r = z.shape[1]
    chunk = ray_chunk or r
    parts = [shade(field, rc, origins[:, i:i + chunk], dirs[:, i:i + chunk],
                   z[:, i:i + chunk], draws.u[:, i:i + chunk], checkpoint)
             for i in range(0, r, chunk)]
    comp, depth, opacity = (torch.cat(t, 1) for t in zip(*parts))
    comp = fill(comp, opacity, rc.fill_mode)
    n = rc.img_size
    pixels = comp.reshape(batch, n, n, -1).permute(0, 3, 1, 2) * 2.0 - 1.0
    return {"pixels": pixels, "depth": depth.reshape(batch, n, n),
            "opacity": opacity.reshape(batch, n, n), "position": position}
