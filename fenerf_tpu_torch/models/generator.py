"""The volumetric generator (port of fenerf_tpu/models/generator.py:
render_core with its gradient subset of rays (_shade_grad_subset), render, render_from_z, render_truncated and the shape
extraction's voxel_points and eval_volume for the FiLM-SIREN family;
render_grid_from_z and eval_volume_grid for the latent-grid family; the
family dispatch get_any_config / init_any_field / render_any).

Pipeline: ray grid -> stratified jitter -> camera -> cam2world -> coarse
field eval -> proposal weights -> sample_pdf -> fine field eval ->
order-independent merge + compositing -> fill -> NCHW pixels in [-1, 1].
With FENERF_RAY_KERNELS (see ray_route) the machinery between the two field
evaluations runs in the fused per-ray kernels of ops/ray_finalize.py.

Randomness: every draw of a render (stratified jitter, camera, importance
uniforms, sigma noise) is drawn ONCE over the whole image, before the ray
blocks are shaded, so chunked rendering equals whole-image rendering. The
draws come from a torch.Generator on the device, or are passed in whole as
`draws` (tests replay the JAX package's draws that way).

Renders are differentiable (the trainer's G phase): no gradient flows
through the proposal (coarse weights -> sample_pdf -> fine z), as in the
JAX package and the reference.
"""
from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.utils.checkpoint

from fenerf_tpu_torch.core import integrate as integ
from fenerf_tpu_torch.core import rays as raylib
from fenerf_tpu_torch.nn import fields
from fenerf_tpu_torch.nn import latent_grid_field as lgf


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static rendering configuration (curriculum metadata plus the
    eval-only knobs)."""
    img_size: int = 64
    num_steps: int = 12
    fov: float = 12.0
    ray_start: float = 0.88
    ray_end: float = 1.12
    h_stddev: float = 0.3
    v_stddev: float = 0.155
    h_mean: float = 1.5707963267948966   # pi/2
    v_mean: float = 1.5707963267948966
    sample_dist: str | None = "gaussian"
    hierarchical: bool = True
    clamp_mode: str = "relu"
    last_back: bool = False
    white_back: bool = False
    black_back: bool = False
    fill_mode: str | None = None
    fill_color: str = "black"
    lock_view_dependence: bool = False
    softmax_label: bool = False
    perturb: bool = True
    ray_chunk: int = 0          # 0 => whole image in one field eval
    compute_dtype: str = "float32"   # 'bfloat16': bf16 matmul operands
    backend: str = "torch"      # 'kernel' => fused field (ops/film_mlp.py),
                                # 'kernel_train' => fused forward + backward
                                # (ops/film_mlp_grad.py)
    remat: bool = False         # torch route: recompute the field in backward
    grad_rays: float = 1.0      # fraction of rays whose pixels carry
                                # gradients (< 1: training only; every ray
                                # renders, a random chunk-aligned subset
                                # runs the differentiable path, the rest
                                # under no_grad; the pixels equal the
                                # grad_rays = 1 render)

    @property
    def n_rays(self) -> int:
        return self.img_size * self.img_size


class RayNoise(NamedTuple):
    """Per-ray randomness over the whole image, sliced per ray block. All
    entries are unscaled draws; consumers scale by noise_std."""
    u: torch.Tensor | None       # (B, R, S) importance-sampling uniforms
    coarse: torch.Tensor | None  # (B, R, S) proposal-pass sigma noise
    final: torch.Tensor | None   # (B, R, S_total) final-pass sigma noise


class RenderDraws(NamedTuple):
    """Every random number one render consumes."""
    jitter: torch.Tensor | None  # (B, R, S) U[0,1) stratified jitter
    cam_h: torch.Tensor | None   # (B, 1) camera yaw draw
    cam_v: torch.Tensor | None   # (B, 1) camera pitch draw
    noise: RayNoise
    ray_perm: torch.Tensor | None = None  # (R,) permutation of the rays
                                          # (grad_rays < 1 only)


def _noise_is_dead(noise_std) -> bool:
    """Statically-zero noise_std (every inference path): the sigma-noise
    draws are skipped, since sigma + 0 * n == sigma."""
    return not isinstance(noise_std, torch.Tensor) and float(noise_std) == 0.0


def draw_ray_noise(gen: torch.Generator, batch: int, n_rays: int,
                   rcfg: RenderConfig, noise_std=1.0,
                   device="cpu") -> RayNoise:
    dead = _noise_is_dead(noise_std)
    s = rcfg.num_steps
    normal = lambda shape: torch.randn(shape, generator=gen, device=device)
    if rcfg.hierarchical:
        return RayNoise(
            u=torch.rand((batch, n_rays, s), generator=gen, device=device),
            coarse=None if dead else normal((batch, n_rays, s)),
            final=None if dead else normal((batch, n_rays, 2 * s)))
    return RayNoise(u=None, coarse=None,
                    final=None if dead else normal((batch, n_rays, s)))


def draw_render(gen: torch.Generator, batch: int, rcfg: RenderConfig,
                noise_std=0.0, camera_mode: str | None = None,
                device="cpu") -> RenderDraws:
    """All draws of one render from `gen` on `device`."""
    shape = (batch, rcfg.n_rays, rcfg.num_steps)
    jitter = (torch.rand(shape, generator=gen, device=device)
              if rcfg.perturb else None)
    cam_h = cam_v = None
    kind = raylib.CAMERA_DRAWS.get(camera_mode) if camera_mode else None
    if kind is not None:
        draw = torch.rand if kind == "uniform" else torch.randn
        cam_h = draw((batch, 1), generator=gen, device=device)
        cam_v = draw((batch, 1), generator=gen, device=device)
    noise = draw_ray_noise(gen, batch, rcfg.n_rays, rcfg, noise_std, device)
    perm = (torch.randperm(rcfg.n_rays, generator=gen, device=device)
            if rcfg.grad_rays < 1.0 else None)
    return RenderDraws(jitter, cam_h, cam_v, noise, perm)


RAY_KERNEL_MODES = ("never", "auto")


def ray_route(rcfg: RenderConfig, device) -> tuple[str, str]:
    """Which route runs the hierarchical machinery between the two field
    evaluations: ("kernels", why) for the fused per-ray kernels
    (ops/ray_finalize.py), else ("torch", why).

    FENERF_RAY_KERNELS, read at every call: 'never' (default, as in the
    JAX package) or 'auto' (the kernels when the backend is kernel /
    kernel_train and the rays are on CUDA). The backend names the
    render's kernel route: the latent-grid field has no kernel and runs
    its torch route whatever the backend, so for that family 'kernel'
    opens the ray kernels alone, as the JAX package's 'pallas' does there
    (XLA field, Pallas ray machinery)."""
    mode = os.environ.get("FENERF_RAY_KERNELS", "never")
    if mode not in RAY_KERNEL_MODES:
        raise ValueError(f"FENERF_RAY_KERNELS={mode!r}: expected one of "
                         f"{RAY_KERNEL_MODES}")
    why = f"FENERF_RAY_KERNELS={mode}, backend {rcfg.backend}"
    if mode == "never" or not rcfg.hierarchical \
            or rcfg.backend not in ("kernel", "kernel_train"):
        return "torch", why
    if rcfg.num_steps < 3:
        # the resample needs at least one interior proposal weight
        return "torch", f"{why}, num_steps {rcfg.num_steps} < 3"
    dev = torch.device(device).type
    if dev != "cuda":
        return "torch", f"{why}, device {dev}"
    return "kernels", f"{why}, device {dev}"


def _shade_rays(field_fn, output_dim, rcfg, origins, dirs, z_vals,
                noise: RayNoise, noise_std):
    """Coarse eval -> proposal weights -> importance resample -> fine eval
    -> order-independent merge + compositing, on a block of rays:
    origins / dirs (B, Rb, 3), z_vals (B, Rb, S). Returns the composite
    before fill, depth and total opacity."""
    b, _, s = z_vals.shape

    def eval_pts(pts, drs):
        rb = pts.shape[1]
        out = field_fn(pts.reshape(b, rb * s, 3), drs.reshape(b, rb * s, 3))
        return out.reshape(b, rb, s, output_dim)

    if (rcfg.remat and rcfg.backend == "torch"
            and torch.is_grad_enabled()):
        # keep only the field's inputs for the backward; the kernel route
        # already saves only its inputs
        plain_eval = eval_pts

        def eval_pts(pts, drs):
            return torch.utils.checkpoint.checkpoint(
                plain_eval, pts, drs, use_reentrant=False)

    points = origins[:, :, None, :] + dirs[:, :, None, :] * z_vals[..., None]
    dirs_exp = dirs[:, :, None, :].expand(points.shape)
    if rcfg.lock_view_dependence:
        dirs_exp = torch.zeros_like(points)
        dirs_exp[..., -1] = -1.0
    coarse = eval_pts(points, dirs_exp)

    if ray_route(rcfg, z_vals.device)[0] == "kernels":
        # the fused per-ray kernels: proposal + resample in one, merge +
        # compositing in the other; fill stays once per image (render_core)
        from fenerf_tpu_torch.ops import ray_finalize as rf

        # the kernels take contiguous rows (ray blocks of B > 1 are views)
        scale = lambda t: None if t is None else (t * noise_std).contiguous()
        z_vals = z_vals.contiguous()
        fine_z = rf.ray_resample(
            coarse[..., -1].detach().contiguous(), z_vals,
            scale(noise.coarse), noise.u.contiguous(),
            clamp_mode=rcfg.clamp_mode).detach()
        fine_pts = (origins[:, :, None, :]
                    + dirs[:, :, None, :] * fine_z[..., None])
        fine = eval_pts(fine_pts, dirs_exp)
        return rf.ray_finalize_vjp(
            fine.contiguous(), coarse.contiguous(), fine_z, z_vals,
            scale(noise.final), clamp_mode=rcfg.clamp_mode,
            last_back=rcfg.last_back, white_back=rcfg.white_back,
            black_back=rcfg.black_back, fill_mode=None,
            fill_color=rcfg.fill_color, softmax_label=False)

    if rcfg.hierarchical:
        # no gradient flows through the proposal (the reference samples it
        # under no_grad)
        coarse_w = integ.integrate_weights(
            coarse[..., -1].detach(), z_vals, noise=noise.coarse,
            noise_std=noise_std, clamp_mode=rcfg.clamp_mode)
        w = coarse_w.detach() + 1e-5
        fine_z = integ.sample_pdf(integ.midpoints(z_vals), w[..., 1:-1],
                                  rcfg.num_steps, u=noise.u).detach()
        fine_pts = (origins[:, :, None, :]
                    + dirs[:, :, None, :] * fine_z[..., None])
        fine = eval_pts(fine_pts, dirs_exp)
        res = integ.composite_merged_nosort(
            fine, coarse, fine_z, z_vals, noise=noise.final,
            noise_std=noise_std, clamp_mode=rcfg.clamp_mode,
            last_back=rcfg.last_back, white_back=rcfg.white_back,
            black_back=rcfg.black_back)
    else:
        res = integ.integrate(
            coarse, z_vals, noise=noise.final, noise_std=noise_std,
            clamp_mode=rcfg.clamp_mode, last_back=rcfg.last_back,
            white_back=rcfg.white_back, black_back=rcfg.black_back)
    return res.comp, res.depth, res.weights_sum


def _finalize_comp(comp, weights_sum, rcfg: RenderConfig):
    """Per-ray fill + optional label softmax, once on the assembled image."""
    comp = integ.apply_fill(comp, weights_sum, rcfg.fill_mode,
                            rcfg.fill_color)
    if rcfg.softmax_label:
        seg, rgb = comp[..., :-3], comp[..., -3:]
        comp = torch.cat([torch.softmax(seg, dim=-1), rgb], dim=-1)
    return comp


def _shade_chunked(field_fn, output_dim, rcfg, origins, dirs, z_vals,
                   noise: RayNoise, noise_std):
    """_shade_rays over fixed-size ray blocks (a Python loop): peak memory
    scales with the block, not the image. Each ray's math is independent
    of its block, so the result equals ray_chunk=0."""
    r = z_vals.shape[1]
    chunk = rcfg.ray_chunk
    if not chunk or chunk >= r:
        return _shade_rays(field_fn, output_dim, rcfg, origins, dirs, z_vals,
                           noise, noise_std)
    if r % chunk:
        raise ValueError(f"ray_chunk {chunk} must divide n_rays {r}")
    parts = []
    for i in range(0, r, chunk):
        sl = lambda t: None if t is None else t[:, i:i + chunk]
        parts.append(_shade_rays(
            field_fn, output_dim, rcfg, sl(origins), sl(dirs), sl(z_vals),
            RayNoise(*(sl(t) for t in noise)), noise_std))
    return tuple(torch.cat(ts, dim=1) for ts in zip(*parts))


def _shade_grad_subset(field_fn, output_dim, rcfg, perm, origins, dirs,
                       z_vals, noise: RayNoise, noise_std):
    """Shade with gradients restricted to a grad_rays fraction of the rays
    (the reference's part_forward, generators.py:858-910, as the JAX
    package recasts it): permute the ray axis by `perm`, shade the first
    n_grad rays (a multiple of ray_chunk) on the differentiable path and
    the rest under no_grad (on the card: the forward kernel alone), then
    undo the permutation. Each ray's math is independent of the others, so
    the pixels equal the grad_rays = 1 render.

    Returns (comp, depth, weights_sum, grad_mask), grad_mask (R,) bool in
    the original ray order (True: the ray's pixel carries gradients)."""
    r = z_vals.shape[1]
    q = rcfg.ray_chunk if (rcfg.ray_chunk and rcfg.ray_chunk < r) else 1
    n_grad = int(round(rcfg.grad_rays * r))
    n_grad = min(r - q, max(q, (n_grad // q) * q))  # chunk-aligned, 0<ng<r
    inv = torch.argsort(perm)
    permute = lambda t: None if t is None else t[:, perm]
    args = ([permute(t) for t in (origins, dirs, z_vals)],
            RayNoise(*(permute(t) for t in noise)))

    def part(a, b):
        sl = lambda t: None if t is None else t[:, a:b]
        o, d, zv = (sl(t) for t in args[0])
        return _shade_chunked(field_fn, output_dim, rcfg, o, d, zv,
                              RayNoise(*(sl(t) for t in args[1])),
                              noise_std)

    out_g = part(0, n_grad)
    with torch.no_grad():
        out_s = part(n_grad, r)
    comp, depth, wsum = (torch.cat([a, b], dim=1)[:, inv]
                         for a, b in zip(out_g, out_s))
    return comp, depth, wsum, inv < n_grad


def _film_field_fn(params, fcfg, rcfg: RenderConfig, film_geo, film_app):
    compute_dtype = (torch.bfloat16 if rcfg.compute_dtype == "bfloat16"
                     else torch.float32)
    # texture table (and the kernel's packed operands) once per render;
    # no-ops when the caller already attached them
    params = fields.with_grid_table(
        params, fcfg,
        torch.bfloat16 if (rcfg.backend != "torch"
                           or compute_dtype == torch.bfloat16) else None)
    if rcfg.backend == "kernel":
        from fenerf_tpu_torch.ops import film_mlp

        params = film_mlp.with_pack(params, fcfg)
    # kernel_train packs the current parameters inside every field call

    def field_fn(pts, drs):
        return fields.apply_field(params, fcfg, pts, drs, film_geo, film_app,
                                  compute_dtype=compute_dtype,
                                  backend=rcfg.backend)

    return field_fn


def render_core(field_fn, output_dim: int, rcfg: RenderConfig,
                batch_size: int, noise_std=0.0, camera: tuple | None = None,
                generator: torch.Generator | None = None,
                draws: RenderDraws | None = None,
                device="cpu") -> dict[str, torch.Tensor]:
    """The full volumetric pipeline around a per-point field
    field_fn(points (B,M,3), dirs (B,M,3)) -> (B,M,output_dim).

    camera: optional (pitch, yaw, fov) overriding the camera distribution
    with a deterministic pose; pitch / yaw may be (B, 1) tensors.
    draws: every random number of the render (RenderDraws); without it
    they come from `generator` (default: seeded 0) on `device`.

    Returns pixels (B, C, H, W) in [-1, 1], depth (B, H, W), opacity
    (B, H, W) and position (B, 2) = sampled (pitch, yaw); with
    rcfg.grad_rays < 1 also grad_ray_mask (H, W), True where a pixel
    carries gradients."""
    if camera is not None:
        pitch, yaw, fov = camera
        h_mean, v_mean = yaw, pitch
        h_stddev = v_stddev = 0.0
        sample_dist = None
    else:
        fov = rcfg.fov
        h_mean, v_mean = rcfg.h_mean, rcfg.v_mean
        h_stddev, v_stddev = rcfg.h_stddev, rcfg.v_stddev
        sample_dist = rcfg.sample_dist
    if draws is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        draws = draw_render(generator, batch_size, rcfg, noise_std,
                            sample_dist, device)

    dirs_cam = raylib.pixel_ray_dirs(rcfg.img_size, fov, device)
    z0 = raylib.initial_z_vals(rcfg.num_steps, rcfg.ray_start, rcfg.ray_end,
                               device)
    tr = raylib.transform_rays(
        batch_size, dirs_cam, z0, h_stddev, v_stddev, h_mean, v_mean,
        mode=sample_dist, jitter=draws.jitter if rcfg.perturb else None,
        cam_h=draws.cam_h, cam_v=draws.cam_v)
    grad_mask = None
    if rcfg.grad_rays < 1.0:
        if draws.ray_perm is None:
            raise ValueError("grad_rays < 1 needs draws.ray_perm")
        comp, depth, weights_sum, grad_mask = _shade_grad_subset(
            field_fn, output_dim, rcfg, draws.ray_perm, tr.ray_origins,
            tr.ray_dirs, tr.z_vals, draws.noise, noise_std)
    else:
        comp, depth, weights_sum = _shade_chunked(
            field_fn, output_dim, rcfg, tr.ray_origins, tr.ray_dirs,
            tr.z_vals, draws.noise, noise_std)
    comp = _finalize_comp(comp, weights_sum, rcfg)
    hw = rcfg.img_size
    pixels = (comp.reshape(batch_size, hw, hw, -1).permute(0, 3, 1, 2)
              * 2.0 - 1.0)
    out = {
        "pixels": pixels,
        "depth": depth.reshape(batch_size, hw, hw),
        "opacity": weights_sum.reshape(batch_size, hw, hw),
        "position": torch.cat([tr.pitch, tr.yaw], dim=-1),
    }
    if grad_mask is not None:
        out["grad_ray_mask"] = grad_mask.reshape(hw, hw)
    return out


def render(params, fcfg: fields.FieldConfig, rcfg: RenderConfig, film_geo,
           film_app, batch_size: int, noise_std=0.0,
           camera: tuple | None = None,
           generator: torch.Generator | None = None,
           draws: RenderDraws | None = None) -> dict[str, torch.Tensor]:
    """Render a batch of images from W-space film activations."""
    field_fn = _film_field_fn(params, fcfg, rcfg, film_geo, film_app)
    return render_core(field_fn, fcfg.output_dim, rcfg, batch_size,
                       noise_std, camera, generator, draws,
                       device=film_geo[0].device)


def render_from_z(params, fcfg: fields.FieldConfig, rcfg: RenderConfig,
                  z_geo, z_app, noise_std=0.0,
                  generator: torch.Generator | None = None,
                  draws: RenderDraws | None = None):
    """Latents -> mapping networks -> render."""
    film_geo, film_app = fields.field_film(params, fcfg, z_geo, z_app)
    return render(params, fcfg, rcfg, film_geo, film_app,
                  batch_size=z_geo.shape[0], noise_std=noise_std,
                  generator=generator, draws=draws)


def _grid_field_fn(params, gcfg: lgf.GridFieldConfig, rcfg: RenderConfig,
                   z: torch.Tensor):
    """The latent-grid field as a per-point closure, its StyleGenerator2D
    plane computed once here, not once per ray block."""
    compute_dtype = (torch.bfloat16 if rcfg.compute_dtype == "bfloat16"
                     else torch.float32)
    plane = lgf.compute_plane(params, gcfg, z)

    def field_fn(pts, drs):
        return lgf.apply_grid_field(params, gcfg, pts, drs, z, plane=plane,
                                    compute_dtype=compute_dtype)

    return field_fn


def render_grid_from_z(params, gcfg: lgf.GridFieldConfig,
                       rcfg: RenderConfig, z: torch.Tensor, noise_std=0.0,
                       camera: tuple | None = None,
                       generator: torch.Generator | None = None,
                       draws: RenderDraws | None = None):
    """Latent-grid family (SPATIALSIRENGRID): z -> StyleGenerator2D plane
    -> per-point local latents -> render."""
    field_fn = _grid_field_fn(params, gcfg, rcfg, z)
    return render_core(field_fn, gcfg.output_dim, rcfg, z.shape[0],
                       noise_std, camera, generator, draws, device=z.device)


# ---------------------------------------------------------------------------
# Family dispatch: the FiLM-SIREN family (FieldConfig) and the latent-grid
# family (GridFieldConfig)
# ---------------------------------------------------------------------------

def get_any_config(model: str, **kwargs):
    """FieldConfig or GridFieldConfig by the reference's model name."""
    if lgf.is_grid_model(model):
        return lgf.get_grid_config(model, **kwargs)
    return fields.get_config(model, **kwargs)


def is_grid_config(cfg) -> bool:
    return isinstance(cfg, lgf.GridFieldConfig)


def init_any_field(gen: torch.Generator, cfg, device="cpu"):
    if is_grid_config(cfg):
        return lgf.init_grid_field(gen, cfg, device)
    return fields.init_field(gen, cfg, device)


def render_any(params, cfg, rcfg: RenderConfig, z_geo, z_app, noise_std=0.0,
               camera: tuple | None = None,
               generator: torch.Generator | None = None,
               draws: RenderDraws | None = None):
    """Family-generic z -> image render. The grid family has one latent:
    z_geo drives the StyleGenerator2D and z_app is not read."""
    if is_grid_config(cfg):
        return render_grid_from_z(params, cfg, rcfg, z_geo, noise_std,
                                  camera, generator, draws)
    film_geo, film_app = fields.field_film(params, cfg, z_geo, z_app)
    return render(params, cfg, rcfg, film_geo, film_app,
                  batch_size=z_geo.shape[0], noise_std=noise_std,
                  camera=camera, generator=generator, draws=draws)


def render_truncated(params, fcfg: fields.FieldConfig, rcfg: RenderConfig,
                     z_geo, z_app, avg, psi=0.7, noise_std=0.0,
                     camera: tuple | None = None,
                     generator: torch.Generator | None = None,
                     draws: RenderDraws | None = None):
    """psi-lerp the film activations toward their average, then render."""
    film_geo, film_app = fields.field_film(params, fcfg, z_geo, z_app)
    film_geo = fields.truncate_film(film_geo, avg[0], psi)
    film_app = fields.truncate_film(film_app, avg[1], psi)
    return render(params, fcfg, rcfg, film_geo, film_app,
                  batch_size=z_geo.shape[0], noise_std=noise_std,
                  camera=camera, generator=generator, draws=draws)


# ---------------------------------------------------------------------------
# Shape extraction: evaluate sigma (+labels) on a voxel lattice
# ---------------------------------------------------------------------------

def voxel_points(resolution: int, cube_length: float = 0.3,
                 device="cpu") -> torch.Tensor:
    """Reference create_samples (extract_double_semantic_shapes.py:13-35):
    a resolution^3 lattice spanning cube_length, centered at the origin.
    Returns (resolution^3, 3) with x fastest (matching the .mrc reshape).

    The side is jnp.linspace(-0.5, 0.5, n) in f32 as XLA computes it:
    t_i = i * f32(1 / (n - 1)), then -0.5 (1 - t_i) + i * (0.5 f32(1 / (n - 1)))
    with the last product added at one rounding (a fused multiply-add)."""
    f32 = np.float32
    div = resolution - 1
    i = np.arange(div, dtype=f32)
    rc = f32(1.0) / f32(div)
    a = f32(-0.5) * (f32(1.0) - i * rc)
    fused = a.astype(np.float64) + i.astype(np.float64) * float(f32(0.5) * rc)
    side = np.append(fused.astype(f32), f32(0.5)) * f32(cube_length)
    side = torch.from_numpy(side).to(device)
    zz, yy, xx = torch.meshgrid(side, side, side, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1), zz.reshape(-1)],
                       dim=-1)


@torch.no_grad()
def eval_volume(params, fcfg: fields.FieldConfig, film_geo, film_app,
                points: torch.Tensor, chunk: int = 262144,
                compute_dtype=torch.float32) -> torch.Tensor:
    """Field outputs over a point cloud (N, 3) with a locked view direction
    (0, 0, -1) (reference extract_double_semantic_shapes.py:57-61), in
    blocks of `chunk` points (the last padded with zeros). Takes the torch
    route, as the JAX function takes XLA's. Returns (N, output_dim)."""
    n = points.shape[0]
    pad = (-n) % chunk
    pts = torch.cat([points, points.new_zeros(pad, 3)]) if pad else points
    # texture table once, outside the chunk loop
    params = fields.with_grid_table(
        params, fcfg,
        torch.bfloat16 if compute_dtype == torch.bfloat16 else None)
    out = []
    for i in range(0, pts.shape[0], chunk):
        p = pts[i:i + chunk]
        d = torch.zeros_like(p)
        d[..., -1] = -1.0
        out.append(fields.apply_field(
            params, fcfg, p[None], d[None], film_geo, film_app,
            compute_dtype=compute_dtype)[0])
    return torch.cat(out)[:n]


@torch.no_grad()
def eval_volume_grid(params, gcfg: lgf.GridFieldConfig, z: torch.Tensor,
                     points: torch.Tensor, chunk: int = 262144,
                     compute_dtype=torch.float32) -> torch.Tensor:
    """The latent-grid analogue of eval_volume: field outputs over points
    (N, 3) for z (1, z_dim) with the locked (0, 0, -1) view direction, in
    blocks of `chunk` points (the last padded with zeros), the plane
    computed once. Returns (N, output_dim)."""
    n = points.shape[0]
    pad = (-n) % chunk
    pts = torch.cat([points, points.new_zeros(pad, 3)]) if pad else points
    plane = lgf.compute_plane(params, gcfg, z)
    out = []
    for i in range(0, pts.shape[0], chunk):
        p = pts[i:i + chunk]
        d = torch.zeros_like(p)
        d[..., -1] = -1.0
        out.append(lgf.apply_grid_field(params, gcfg, p[None], d[None], z,
                                        plane=plane,
                                        compute_dtype=compute_dtype)[0])
    return torch.cat(out)[:n]
