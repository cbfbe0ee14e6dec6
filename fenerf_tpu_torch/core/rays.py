"""Camera and ray generation (port of fenerf_tpu/core/rays.py).

Rays keep the (R, S) layout; z_vals are (..., S). Randomness is explicit:
every function that draws takes its raw draws as tensors (`jitter`,
`cam_h`, `cam_v`), so tests can replay the JAX package's draws and the
renderer can draw them from a torch.Generator on the device.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


def normalize_vecs(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit-normalize along the last axis."""
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=eps)


def pixel_ray_dirs(img_size: int, fov_degrees, device="cpu") -> torch.Tensor:
    """Unit camera-space ray directions, (img_size**2, 3) row-major:
    x = -1 + 2b/(W-1), y = 1 - 2a/(H-1), z = -1/tan(fov/2). fov may be a
    float or a 0-d tensor."""
    w = h = img_size
    x = torch.linspace(-1.0, 1.0, w, device=device)
    y = torch.linspace(1.0, -1.0, h, device=device)
    xx = x[None, :].expand(h, w).reshape(-1)
    yy = y[:, None].expand(h, w).reshape(-1)
    fov = torch.as_tensor(fov_degrees, dtype=torch.float32, device=device)
    zz = (-1.0 / torch.tan(torch.deg2rad(fov) / 2.0)).expand(xx.shape)
    return normalize_vecs(torch.stack([xx, yy, zz], dim=-1))


def initial_z_vals(num_steps: int, ray_start: float, ray_end: float,
                   device="cpu") -> torch.Tensor:
    """Evenly spaced sample distances along each ray, (num_steps,)."""
    return torch.linspace(ray_start, ray_end, num_steps, device=device)


def perturb_z(jitter: torch.Tensor, z_vals: torch.Tensor) -> torch.Tensor:
    """Stratified jitter from U[0,1) draws `jitter` (z_vals.shape): offset
    in [-dz/2, dz/2) with dz the first inter-sample gap."""
    dz = z_vals[..., 1:2] - z_vals[..., 0:1]
    return z_vals + (jitter - 0.5) * dz


class CameraSample(NamedTuple):
    origin: torch.Tensor  # (n, 3)
    pitch: torch.Tensor   # (n, 1) phi in (0, pi)
    yaw: torch.Tensor     # (n, 1) theta


CAMERA_DRAWS = {"uniform": "uniform", "normal": "normal",
                "gaussian": "normal", "spherical_uniform": "uniform",
                "hybrid": "hybrid", "truncated_gaussian": "truncated"}


def truncated_normal(shape, generator: torch.Generator | None = None,
                     lower: float = -2.0, upper: float = 2.0,
                     device="cpu") -> torch.Tensor:
    """Standard normals truncated to [lower, upper] by the inverse CDF of
    uniform draws (as jax.random.truncated_normal draws them)."""
    cdf = lambda x: 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))
    lo, hi = cdf(lower), cdf(upper)
    u = torch.rand(shape, generator=generator, device=device)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
    return x.clamp(lower, upper)


def sample_camera(n: int, h_stddev, v_stddev, h_mean, v_mean,
                  mode: str | None = "normal", r: float = 1.0,
                  cam_h: torch.Tensor | None = None,
                  cam_v: torch.Tensor | None = None,
                  cam_coin: torch.Tensor | None = None,
                  device="cpu") -> CameraSample:
    """Camera positions on a sphere. cam_h / cam_v are the raw (n, 1)
    draws of the mode (see CAMERA_DRAWS): standard normals, U[0,1), or
    normals truncated to [-2, 2]; for 'hybrid' they are (n, 2), the normal
    draw in column 0 and the uniform one in column 1, and cam_coin (a
    bool, one for the whole batch) picks the uniform branch (the
    reference flips one coin per call). Mode None, or any mode not named
    above, is the deterministic mean, where h_mean / v_mean may be (n, 1)
    tensors (one pose per micro-batched request)."""
    shape = (n, 1)
    if mode == "uniform":
        theta = (cam_h - 0.5) * 2 * h_stddev + h_mean
        phi = (cam_v - 0.5) * 2 * v_stddev + v_mean
    elif mode in ("normal", "gaussian", "truncated_gaussian"):
        theta = cam_h * h_stddev + h_mean
        phi = cam_v * v_stddev + v_mean
    elif mode == "hybrid":
        # the uniform branch spans twice the stddev (rays.py:93-103)
        theta_u = (cam_h[:, 1:] - 0.5) * 2 * h_stddev * 2 + h_mean
        phi_u = (cam_v[:, 1:] - 0.5) * 2 * v_stddev * 2 + v_mean
        theta_n = cam_h[:, :1] * h_stddev + h_mean
        phi_n = cam_v[:, :1] * v_stddev + v_mean
        theta = torch.where(cam_coin, theta_u, theta_n)
        phi = torch.where(cam_coin, phi_u, phi_n)
    elif mode == "spherical_uniform":
        theta = (cam_h - 0.5) * 2 * h_stddev + h_mean
        v_std, v_mn = v_stddev / math.pi, v_mean / math.pi
        v = ((cam_v - 0.5) * 2 * v_std + v_mn).clamp(1e-5, 1 - 1e-5)
        phi = torch.arccos(1 - 2 * v)
    else:
        # None or an unknown mode: the deterministic mean (the reference's
        # else branch)
        theta = torch.as_tensor(h_mean, dtype=torch.float32,
                                device=device).expand(shape)
        phi = torch.as_tensor(v_mean, dtype=torch.float32,
                              device=device).expand(shape)
    phi = phi.clamp(1e-5, math.pi - 1e-5)
    sin_phi = torch.sin(phi)
    origin = torch.cat([r * sin_phi * torch.cos(theta), r * torch.cos(phi),
                        r * sin_phi * torch.sin(theta)], dim=-1)
    return CameraSample(origin=origin, pitch=phi, yaw=theta)


def cam2world_matrix(forward: torch.Tensor,
                     origin: torch.Tensor) -> torch.Tensor:
    """4x4 cam->world matrices; rotation columns (-left, up, -forward)
    with up seeded at +Y."""
    n = forward.shape[0]
    forward = normalize_vecs(forward)
    up0 = torch.tensor([0.0, 1.0, 0.0], device=forward.device,
                       dtype=forward.dtype).expand(forward.shape)
    left = normalize_vecs(torch.linalg.cross(up0, forward, dim=-1))
    up = normalize_vecs(torch.linalg.cross(forward, left, dim=-1))
    eye = torch.eye(4, device=forward.device, dtype=forward.dtype)
    rotation = eye.repeat(n, 1, 1)
    rotation[:, :3, :3] = torch.stack([-left, up, -forward], dim=-1)
    translation = eye.repeat(n, 1, 1)
    translation[:, :3, 3] = origin
    return translation @ rotation


class TransformedRays(NamedTuple):
    z_vals: torch.Tensor       # (n, R, S)
    ray_dirs: torch.Tensor     # (n, R, 3) world-space unit directions
    ray_origins: torch.Tensor  # (n, R, 3)
    pitch: torch.Tensor        # (n, 1)
    yaw: torch.Tensor          # (n, 1)


def transform_rays(n: int, ray_dirs_cam: torch.Tensor, z_vals: torch.Tensor,
                   h_stddev, v_stddev, h_mean, v_mean,
                   mode: str | None = "normal",
                   jitter: torch.Tensor | None = None,
                   cam_h: torch.Tensor | None = None,
                   cam_v: torch.Tensor | None = None,
                   cam_coin: torch.Tensor | None = None) -> TransformedRays:
    """Jitter the samples (when `jitter` is given), place a camera per batch
    element and map the rays to world space. Sample points are formed by
    the caller as origin + dir * z."""
    num_rays = ray_dirs_cam.shape[0]
    num_steps = z_vals.shape[0]
    z = z_vals[None, None, :].expand(n, num_rays, num_steps)
    if jitter is not None:
        z = perturb_z(jitter, z)
    else:
        z = z.contiguous()
    cam = sample_camera(n, h_stddev, v_stddev, h_mean, v_mean, mode,
                        cam_h=cam_h, cam_v=cam_v, cam_coin=cam_coin,
                        device=z_vals.device)
    forward = normalize_vecs(-cam.origin)
    c2w = cam2world_matrix(forward, cam.origin)
    rot = c2w[:, :3, :3]
    trans = c2w[:, :3, 3]
    dirs_world = torch.einsum("nij,rj->nri", rot, ray_dirs_cam)
    origins_world = trans[:, None, :].expand(n, num_rays, 3)
    return TransformedRays(z_vals=z, ray_dirs=dirs_world,
                           ray_origins=origins_world, pitch=cam.pitch,
                           yaw=cam.yaw)


# ---------------------------------------------------------------------------
# EG3D's camera (NVlabs/eg3d camera_utils.py::LookAtPoseSampler,
# create_cam2world_matrix, FOV_to_intrinsics; volumetric_rendering/
# ray_sampler.py::RaySampler)
# ---------------------------------------------------------------------------

EG3D_FOCAL = 4.2647     # FOV_to_intrinsics(18.837): 1 / (tan(fov / 2) 1.414)
EG3D_RADIUS = 2.7
EG3D_PIVOT = (0.0, 0.0, 0.2)


def lookat_cam2world(yaw: torch.Tensor, pitch: torch.Tensor) -> torch.Tensor:
    """LookAtPoseSampler at the angles yaw, pitch (B, 1): the camera on the
    sphere of EG3D_RADIUS about the origin, looking at EG3D_PIVOT; its
    cam2world rotation columns (right, up, forward) with up seeded at +Y.
    -> (B, 4, 4)."""
    v = pitch.clamp(1e-5, math.pi - 1e-5) / math.pi
    phi = torch.arccos(1 - 2 * v)
    r = EG3D_RADIUS
    origin = torch.cat([r * torch.sin(phi) * torch.cos(math.pi - yaw),
                        r * torch.cos(phi),
                        r * torch.sin(phi) * torch.sin(math.pi - yaw)], dim=-1)
    look = torch.tensor(EG3D_PIVOT, dtype=origin.dtype, device=origin.device)
    forward = normalize_vecs(look - origin)
    up0 = torch.tensor([0.0, 1.0, 0.0], dtype=origin.dtype,
                       device=origin.device).expand_as(forward)
    right = -normalize_vecs(torch.linalg.cross(up0, forward, dim=-1))
    up = normalize_vecs(torch.linalg.cross(forward, right, dim=-1))
    eye = torch.eye(4, dtype=origin.dtype, device=origin.device)
    rotation = eye.repeat(origin.shape[0], 1, 1)
    rotation[:, :3, :3] = torch.stack([right, up, forward], dim=-1)
    translation = eye.repeat(origin.shape[0], 1, 1)
    translation[:, :3, 3] = origin
    return translation @ rotation


def eg3d_intrinsics(batch: int, device="cpu") -> torch.Tensor:
    """Normalised intrinsics (B, 3, 3): EG3D_FOCAL, principal point 0.5."""
    f = EG3D_FOCAL
    k = torch.tensor([[f, 0.0, 0.5], [0.0, f, 0.5], [0.0, 0.0, 1.0]],
                     device=device)
    return k.expand(batch, 3, 3).contiguous()


def eg3d_label(cam2world: torch.Tensor,
               intrinsics: torch.Tensor) -> torch.Tensor:
    """The conditioning label c (B, 25): cam2world's 16 values, then the
    intrinsics' 9, row-major."""
    b = cam2world.shape[0]
    return torch.cat([cam2world.reshape(b, 16), intrinsics.reshape(b, 9)],
                     dim=1)


def eg3d_rays(c: torch.Tensor, resolution: int):
    """RaySampler: rays through the pixel centres of a resolution^2 image
    for the cameras of label c (B, 25). -> origins, unit directions
    (B, resolution^2, 3), rows top to bottom."""
    b = c.shape[0]
    c2w = c[:, :16].reshape(b, 4, 4)
    k = c[:, 16:25].reshape(b, 3, 3)
    fx, fy = k[:, 0, 0, None], k[:, 1, 1, None]
    cx, cy, sk = k[:, 0, 2, None], k[:, 1, 2, None], k[:, 0, 1, None]
    ar = torch.arange(resolution, dtype=torch.float32, device=c.device)
    uv = torch.stack(torch.meshgrid(ar, ar, indexing="ij")) \
        * (1.0 / resolution) + (0.5 / resolution)
    uv = uv.flip(0).reshape(2, -1).T                     # (R, 2): (x, y)
    x_cam, y_cam = uv[None, :, 0], uv[None, :, 1]
    x_lift = (x_cam - cx + cy * sk / fy - sk * y_cam / fy) / fx
    y_lift = (y_cam - cy) / fy
    ones = torch.ones_like(x_lift)
    cam = torch.stack([x_lift, y_lift, ones, ones], dim=-1)
    world = torch.bmm(c2w, cam.permute(0, 2, 1)).permute(0, 2, 1)[..., :3]
    origin = c2w[:, :3, 3]
    dirs = torch.nn.functional.normalize(world - origin[:, None, :], dim=2)
    return origin[:, None, :].expand_as(dirs).contiguous(), dirs


def eg3d_depths(jitter: torch.Tensor, ray_start: float, ray_end: float
                ) -> torch.Tensor:
    """sample_stratified: linspace(ray_start, ray_end, S) plus U[0, 1)
    draws `jitter` (B, R, S) times the spacing."""
    s = jitter.shape[-1]
    z = torch.linspace(ray_start, ray_end, s, device=jitter.device)
    return z + jitter * ((ray_end - ray_start) / (s - 1))
