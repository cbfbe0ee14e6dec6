"""The volumetric generator (port of fenerf_tpu/models/generator.py:
render_core with its gradient subset of rays (_shade_grad_subset), render, render_from_z, render_truncated and the shape
extraction's voxel_points and eval_volume for the FiLM-SIREN family;
render_grid_from_z and eval_volume_grid for the latent-grid family; the
same over several devices (render_core's strips of rows and the lattice's
slabs, with render_image_sharded / render_grid_sharded and
eval_volume_sharded / eval_volume_grid_sharded naming them); render_eg3d
for EG3D's tri-plane family (nn/triplane_field.py: its camera, its
importance renderer and MipRayMarcher2 in the same ray blocks and spans,
the super-resolution); the family dispatch get_any_config /
init_any_field / render_any).

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

import contextlib
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
from fenerf_tpu_torch.nn import triplane_field as tpf
from fenerf_tpu_torch.nn.neural_renderer import apply_neural_renderer
from fenerf_tpu_torch.utils.precision import exact_matmuls
from fenerf_tpu_torch.utils.profiling import span


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
    cam_h: torch.Tensor | None   # (B, 1) camera yaw draw ((B, 2): hybrid)
    cam_v: torch.Tensor | None   # (B, 1) camera pitch draw ((B, 2): hybrid)
    noise: RayNoise
    ray_perm: torch.Tensor | None = None  # (R,) permutation of the rays
                                          # (grad_rays < 1 only)
    cam_coin: torch.Tensor | None = None  # () bool, one for the batch
                                          # (camera mode 'hybrid' only)


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
    cam_h = cam_v = coin = None
    # an unknown mode renders the mean pose and draws nothing
    kind = raylib.CAMERA_DRAWS.get(camera_mode) if camera_mode else None
    if kind == "hybrid":
        # the normal pair, the uniform pair and one coin for the batch
        normal = [torch.randn((batch, 1), generator=gen, device=device)
                  for _ in range(2)]
        unif = [torch.rand((batch, 1), generator=gen, device=device)
                for _ in range(2)]
        cam_h, cam_v = (torch.cat([n, u], dim=1)
                        for n, u in zip(normal, unif))
        coin = torch.rand((), generator=gen, device=device) < 0.5
    elif kind is not None:
        draw = {"uniform": torch.rand, "normal": torch.randn,
                "truncated": lambda shape, generator, device:
                raylib.truncated_normal(shape, generator, device=device)
                }[kind]
        cam_h = draw((batch, 1), generator=gen, device=device)
        cam_v = draw((batch, 1), generator=gen, device=device)
    noise = draw_ray_noise(gen, batch, rcfg.n_rays, rcfg, noise_std, device)
    perm = (torch.randperm(rcfg.n_rays, generator=gen, device=device)
            if rcfg.grad_rays < 1.0 else None)
    return RenderDraws(jitter, cam_h, cam_v, noise, perm, coin)


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

    def run_field(pts, drs):
        rb = pts.shape[1]
        out = field_fn(pts.reshape(b, rb * s, 3), drs.reshape(b, rb * s, 3))
        return out.reshape(b, rb, s, output_dim)

    if (rcfg.remat and rcfg.backend == "torch"
            and torch.is_grad_enabled()):
        # keep only the field's inputs for the backward; the kernel route
        # already saves only its inputs
        plain_field = run_field

        def run_field(pts, drs):
            return torch.utils.checkpoint.checkpoint(
                plain_field, pts, drs, use_reentrant=False)

    # the span outside the checkpoint: a backward's recompute is not one of
    # the render's field calls
    def eval_pts(pts, drs):
        with span("fenerf/render/field", rows=b * pts.shape[1] * s):
            return run_field(pts, drs)

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


def _shade_strips(field_fn, output_dim, rcfg, origins, dirs, z_vals,
                  noise: RayNoise, noise_std, devices):
    """_shade_chunked over len(devices) equal strips of the ray axis (whole
    pixel rows), strip i on devices[i], enqueued with no wait in between
    and put together on the device of the inputs. Each ray's math is
    independent of its strip, so the result equals one strip, bit for bit
    where each strip is a whole number of ray_chunk blocks."""
    home = z_vals.device
    rows = z_vals.shape[1] // len(devices)
    parts = []
    for i, dev in enumerate(devices):
        sl = slice(i * rows, (i + 1) * rows)
        cut = lambda t: None if t is None else t[:, sl].to(dev)
        ns = (noise_std.to(dev) if isinstance(noise_std, torch.Tensor)
              else noise_std)
        with _device_context(dev):
            parts.append(_shade_chunked(
                field_fn, output_dim, rcfg, cut(origins), cut(dirs),
                cut(z_vals), RayNoise(*(cut(t) for t in noise)), ns))
    return tuple(torch.cat([p[k].to(home) for p in parts], dim=1)
                 for k in range(3))


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


def _on(tree, dev):
    """`tree`'s tensors (and those of a dataclass leaf such as a FilmPack)
    on `dev`, with no copy where they already are."""
    from fenerf_tpu_torch.compat.jax_bridge import tree_map

    def move(t):
        if isinstance(t, torch.Tensor):
            return t.to(dev)
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            return dataclasses.replace(t, **{
                f.name: getattr(t, f.name).to(dev)
                for f in dataclasses.fields(t) if f.init
                and isinstance(getattr(t, f.name), torch.Tensor)})
        return t

    return tree_map(move, tree)


def _device_context(dev):
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _by_device(home, here, make):
    """`here` on device `home`, make(dev) once on any other device: a field
    closure reads its parameters where its points lie, so the strips and
    slabs of a sharded render or lattice each read their own device's
    copy, and an unsharded call reads `here` untouched."""
    made = {torch.device(home): here}

    def on(dev):
        if dev not in made:
            made[dev] = make(dev)
        return made[dev]

    return on


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
    here = (params, film_geo, film_app)
    on = _by_device(film_geo[0].device, here, lambda dev: _on(here, dev))

    def field_fn(pts, drs):
        p, fg, fa = on(pts.device)
        return fields.apply_field(p, fcfg, pts, drs, fg, fa,
                                  compute_dtype=compute_dtype,
                                  backend=rcfg.backend)

    return field_fn


def render_core(field_fn, output_dim: int, rcfg: RenderConfig,
                batch_size: int, noise_std=0.0, camera: tuple | None = None,
                generator: torch.Generator | None = None,
                draws: RenderDraws | None = None,
                device="cpu", devices=None) -> dict[str, torch.Tensor]:
    """The full volumetric pipeline around a per-point field
    field_fn(points (B,M,3), dirs (B,M,3)) -> (B,M,output_dim).

    camera: optional (pitch, yaw, fov) overriding the camera distribution
    with a deterministic pose; pitch / yaw may be (B, 1) tensors.
    draws: every random number of the render (RenderDraws); without it
    they come from `generator` (default: seeded 0) on `device`.
    devices: ray-parallel rendering (the JAX package's shard_map over a
    mesh; a sequence of torch.devices stands in for the mesh and may
    repeat a device). The pixel rows are split into len(devices) equal
    strips, strip i shaded on devices[i] and put together on devices[0],
    where the draws are made once for the whole image; field_fn reads its
    parameters on each strip's device (_by_device). The result equals the
    unsharded render (_shade_strips). Evaluation only: not with grad_rays.

    Returns pixels (B, C, H, W) in [-1, 1], depth (B, H, W), opacity
    (B, H, W) and position (B, 2) = sampled (pitch, yaw); with
    rcfg.grad_rays < 1 also grad_ray_mask (H, W), True where a pixel
    carries gradients."""
    with span("fenerf/render"):
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
        if devices:
            devices = [torch.device(d) for d in devices]
            device = devices[0]
            if rcfg.img_size % len(devices):
                raise ValueError(f"img_size {rcfg.img_size} is not divisible "
                                 f"into {len(devices)} strips")
            if rcfg.grad_rays < 1.0:
                raise ValueError("ray-parallel renders take no grad_rays")
        if draws is None:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            draws = draw_render(generator, batch_size, rcfg, noise_std,
                                sample_dist, device)

        dirs_cam = raylib.pixel_ray_dirs(rcfg.img_size, fov, device)
        z0 = raylib.initial_z_vals(rcfg.num_steps, rcfg.ray_start,
                                   rcfg.ray_end, device)
        tr = raylib.transform_rays(
            batch_size, dirs_cam, z0, h_stddev, v_stddev, h_mean, v_mean,
            mode=sample_dist, jitter=draws.jitter if rcfg.perturb else None,
            cam_h=draws.cam_h, cam_v=draws.cam_v, cam_coin=draws.cam_coin)
        grad_mask = None
        if rcfg.grad_rays < 1.0:
            if draws.ray_perm is None:
                raise ValueError("grad_rays < 1 needs draws.ray_perm")
            comp, depth, weights_sum, grad_mask = _shade_grad_subset(
                field_fn, output_dim, rcfg, draws.ray_perm, tr.ray_origins,
                tr.ray_dirs, tr.z_vals, draws.noise, noise_std)
        elif devices:
            comp, depth, weights_sum = _shade_strips(
                field_fn, output_dim, rcfg, tr.ray_origins, tr.ray_dirs,
                tr.z_vals, draws.noise, noise_std, devices)
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
           draws: RenderDraws | None = None,
           devices=None) -> dict[str, torch.Tensor]:
    """Render a batch of images from W-space film activations (over
    `devices` in strips of rows: render_core)."""
    field_fn = _film_field_fn(params, fcfg, rcfg, film_geo, film_app)
    return render_core(field_fn, fcfg.output_dim, rcfg, batch_size,
                       noise_std, camera, generator, draws,
                       device=film_geo[0].device, devices=devices)


def render_from_z(params, fcfg: fields.FieldConfig, rcfg: RenderConfig,
                  z_geo, z_app, noise_std=0.0,
                  generator: torch.Generator | None = None,
                  draws: RenderDraws | None = None):
    """Latents -> mapping networks -> render."""
    film_geo, film_app = fields.field_film(params, fcfg, z_geo, z_app)
    return render(params, fcfg, rcfg, film_geo, film_app,
                  batch_size=z_geo.shape[0], noise_std=noise_std,
                  generator=generator, draws=draws)


def _grid_field_fn(params, gcfg: lgf.GridFieldConfig, z: torch.Tensor,
                   compute_dtype, plane: torch.Tensor | None = None):
    """The latent-grid field as a per-point closure, its StyleGenerator2D
    plane computed once here (or given), not once per ray block, and once
    on each other device its points lie on (it depends on z alone)."""
    if plane is None:
        plane = lgf.compute_plane(params, gcfg, z)

    def make(dev):
        p, zd = _on((params, z), dev)
        return p, zd, lgf.compute_plane(p, gcfg, zd)

    on = _by_device(z.device, (params, z, plane), make)

    def field_fn(pts, drs):
        p, zd, pl = on(pts.device)
        return lgf.apply_grid_field(p, gcfg, pts, drs, zd, plane=pl,
                                    compute_dtype=compute_dtype)

    return field_fn


def render_grid_from_z(params, gcfg: lgf.GridFieldConfig,
                       rcfg: RenderConfig, z: torch.Tensor, noise_std=0.0,
                       camera: tuple | None = None,
                       generator: torch.Generator | None = None,
                       draws: RenderDraws | None = None, devices=None):
    """Latent-grid family (SPATIALSIRENGRID): z -> StyleGenerator2D plane
    -> per-point local latents -> render (over `devices` in strips of
    rows: render_core)."""
    compute_dtype = (torch.bfloat16 if rcfg.compute_dtype == "bfloat16"
                     else torch.float32)
    field_fn = _grid_field_fn(params, gcfg, z, compute_dtype)
    return render_core(field_fn, gcfg.output_dim, rcfg, z.shape[0],
                       noise_std, camera, generator, draws, device=z.device,
                       devices=devices)


# ---------------------------------------------------------------------------
# Ray-parallel renders: render_core over several devices
# ---------------------------------------------------------------------------

def render_image_sharded(params, fcfg: fields.FieldConfig,
                         rcfg: RenderConfig, film_geo, film_app, devices,
                         camera: tuple, batch_size: int = 1, noise_std=0.0,
                         return_depth: bool = False,
                         generator: torch.Generator | None = None,
                         draws: RenderDraws | None = None):
    """render(camera=..., devices=devices): one image's pixel rows in
    len(devices) strips (render_core). Returns pixels (B, C, H, W), plus
    depth (B, H, W) with return_depth."""
    out = render(params, fcfg, rcfg, film_geo, film_app, batch_size,
                 noise_std, camera, generator, draws, devices=devices)
    return (out["pixels"], out["depth"]) if return_depth else out["pixels"]


def render_grid_sharded(params, gcfg: lgf.GridFieldConfig,
                        rcfg: RenderConfig, z: torch.Tensor, devices,
                        camera: tuple, noise_std=0.0,
                        return_depth: bool = False,
                        generator: torch.Generator | None = None,
                        draws: RenderDraws | None = None):
    """render_image_sharded for the latent-grid family."""
    out = render_grid_from_z(params, gcfg, rcfg, z, noise_std, camera,
                             generator, draws, devices=devices)
    return (out["pixels"], out["depth"]) if return_depth else out["pixels"]


# ---------------------------------------------------------------------------
# Family dispatch: the FiLM-SIREN family (FieldConfig) and the latent-grid
# family (GridFieldConfig)
# ---------------------------------------------------------------------------

def get_any_config(model: str, **kwargs):
    """FieldConfig, GridFieldConfig or TriPlaneConfig by the model's
    published class name."""
    if lgf.is_grid_model(model):
        return lgf.get_grid_config(model, **kwargs)
    if tpf.is_triplane_model(model):
        return tpf.get_triplane_config(model, **kwargs)
    return fields.get_config(model, **kwargs)


def is_grid_config(cfg) -> bool:
    return isinstance(cfg, lgf.GridFieldConfig)


def is_triplane_config(cfg) -> bool:
    return isinstance(cfg, tpf.TriPlaneConfig)


def init_any_field(gen: torch.Generator, cfg, device="cpu"):
    if is_grid_config(cfg):
        return lgf.init_grid_field(gen, cfg, device)
    if is_triplane_config(cfg):
        return tpf.init_triplane_generator(gen, cfg, device)
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
# EG3D's tri-plane family (nn/triplane_field.py)
# ---------------------------------------------------------------------------

def eg3d_render_config(img_size: int = 128, num_steps: int = 48,
                       ray_chunk: int = 4096, ray_start: float = 2.25,
                       ray_end: float = 3.3) -> RenderConfig:
    """EG3D's ffhq rendering: 128^2 neural rendering, 48 stratified + 48
    importance samples on [2.25, 3.3] (render_eg3d marches them with
    MipRayMarcher2, no background)."""
    return RenderConfig(img_size=img_size, num_steps=num_steps,
                        ray_start=ray_start, ray_end=ray_end,
                        ray_chunk=ray_chunk)


def draw_eg3d(gen: torch.Generator, batch: int, rcfg: RenderConfig,
              device="cpu") -> RenderDraws:
    """One EG3D render's draws: the stratified jitter and the importance
    uniforms, U[0, 1) (B, R, S) each."""
    shape = (batch, rcfg.n_rays, rcfg.num_steps)
    jitter = torch.rand(shape, generator=gen, device=device)
    u = torch.rand(shape, generator=gen, device=device)
    return RenderDraws(jitter, None, None, RayNoise(u, None, None))


def _shade_mip(field_fn, output_dim, rcfg, origins, dirs, z_vals, u):
    """EG3D's ImportanceRenderer on a block of rays (render_core's ray
    blocks and field span): the coarse pass, the proposal from
    MipRayMarcher2's weights smoothed (integrate.py::
    smooth_importance_weights), num_steps depths drawn at the uniforms u
    over the coarse midpoints with the weights' interior, the fine pass,
    both sample sets merged by sorting and marched again. Returns the
    composite, depth and total opacity."""
    b, rb, s = z_vals.shape
    drs = dirs[:, :, None, :].expand(b, rb, s, 3).reshape(b, rb * s, 3)

    def eval_at(zs):
        pts = origins[:, :, None, :] + dirs[:, :, None, :] * zs[..., None]
        with span("fenerf/render/field", rows=b * rb * s):
            out = field_fn(pts.reshape(b, rb * s, 3), drs)
        return out.reshape(b, rb, s, output_dim)

    coarse = eval_at(z_vals)
    with torch.no_grad():
        w = integ.mip_march(coarse[..., :-1], coarse[..., -1], z_vals)[2]
        w = integ.smooth_importance_weights(w)
        fine_z = integ.sample_pdf(integ.midpoints(z_vals), w[..., 1:-1],
                                  rcfg.num_steps, u=u)
    fine = eval_at(fine_z)
    all_z, order = torch.sort(torch.cat([z_vals, fine_z], dim=-1), dim=-1)
    out = torch.cat([coarse, fine], dim=-2)
    out = out.gather(-2, order[..., None].expand_as(out))
    comp, depth, weights = integ.mip_march(out[..., :-1], out[..., -1], all_z)
    return comp, depth, weights.sum(-1)


def render_eg3d(params, cfg: tpf.TriPlaneConfig, rcfg: RenderConfig,
                z: torch.Tensor, c: torch.Tensor,
                camera: torch.Tensor | None = None, psi: float = 1.0,
                generator: torch.Generator | None = None,
                draws: RenderDraws | None = None) -> dict[str, torch.Tensor]:
    """TriPlaneGenerator.forward: z (B, z_dim) and the conditioning label c
    (B, 25) -> w -> the backbone's planes -> the 32-channel feature image
    rendered from `camera` (a label (B, 25); default c) in render_core's
    ray blocks and spans -> super-resolved (the backbone's noise in mode
    'const', none in the super-resolution). Randomness comes whole in
    `draws` (draw_eg3d), else from `generator` (default: seeded 0).

    Returns image (B, 3, img, img) and image_raw (B, 3, n, n) in [-1, 1],
    depth and opacity (B, n, n), features (B, plane_ch, n, n)."""
    b, dev, n = z.shape[0], z.device, rcfg.img_size
    camera = c if camera is None else camera
    if draws is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        draws = draw_eg3d(generator, b, rcfg, dev)
    w = tpf.mapping(params, z, c, psi)
    pl = tpf.planes(params, cfg, w)
    with span("fenerf/render"), exact_matmuls():
        origins, dirs = raylib.eg3d_rays(camera, n)
        z_vals = raylib.eg3d_depths(draws.jitter, rcfg.ray_start,
                                    rcfg.ray_end)
        field = tpf.field_fn(params, cfg, pl)
        chunk = rcfg.ray_chunk or n * n
        parts = [_shade_mip(field, cfg.output_dim, rcfg,
                            *(t[:, i:i + chunk] for t in
                              (origins, dirs, z_vals, draws.noise.u)))
                 for i in range(0, n * n, chunk)]
        comp, depth, wsum = (torch.cat(ts, dim=1) for ts in zip(*parts))
        feats = (comp * 2 - 1).reshape(b, n, n, -1).permute(0, 3, 1, 2)
    image = tpf.superres(params, cfg, feats[:, :3], feats, w)
    return {"image": image, "image_raw": feats[:, :3],
            "depth": depth.reshape(b, n, n),
            "opacity": wsum.reshape(b, n, n), "features": feats}


def render_hd(params, fcfg: fields.FieldConfig, rcfg: RenderConfig,
              film_geo, film_app, batch_size: int, nr_img_params, nr_img_cfg,
              nr_seg_params=None, nr_seg_cfg=None, noise_std=0.0,
              camera: tuple | None = None,
              generator: torch.Generator | None = None,
              draws: RenderDraws | None = None) -> dict[str, torch.Tensor]:
    """StyleGenerator3d's path (generators.py:914-1018): a volumetric
    render at the feature resolution (rcfg.img_size) of an *HD variant's
    64-channel features, then the neural renderer's upsampling to RGB
    (nn/neural_renderer.py) and, with a seg head, the first 64 channels
    (label features) through their own renderer. rcfg.fill_mode should be
    None: the composite is features, not labels and RGB."""
    out = render(params, fcfg, rcfg, film_geo, film_app, batch_size,
                 noise_std, camera, generator, draws)
    # undo render_core's * 2 - 1: the reference feeds the raw composite to
    # the renderer and maps only the final RGB to [-1, 1]
    # (generators.py:1008-1018)
    feats = (out["pixels"].float() + 1.0) * 0.5
    if nr_seg_params is not None:
        labels = apply_neural_renderer(nr_seg_params, nr_seg_cfg,
                                       feats[:, :64])
        images = apply_neural_renderer(nr_img_params, nr_img_cfg,
                                       feats[:, 64:])
        pixels = torch.cat([labels, images], dim=1) * 2.0 - 1.0
    else:
        pixels = apply_neural_renderer(nr_img_params, nr_img_cfg,
                                       feats) * 2.0 - 1.0
    return {**out, "pixels": pixels}


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


def _eval_lattice(field_fn, points: torch.Tensor, chunk: int, devices):
    """field_fn over points (N, 3) with the locked (0, 0, -1) view direction
    (reference extract_double_semantic_shapes.py:57-61), in blocks of
    `chunk` points, the last padded with zeros. With `devices` the padded
    lattice is cut into len(devices) contiguous slabs, slab i on
    devices[i], with the JAX package's padding and block size (a slab a
    multiple of `chunk` keeps the whole lattice's blocks), put together on
    devices[0]. Returns (N, output_dim)."""
    n = points.shape[0]
    if devices:
        devices = [torch.device(d) for d in devices]
        nd = len(devices)
        pad = (-n) % (nd * chunk) if n > nd * chunk else (-n) % nd
        chunk = min(chunk, (n + pad) // nd)
    else:
        devices, pad = [points.device], (-n) % chunk
    pts = torch.cat([points, points.new_zeros(pad, 3)]) if pad else points
    per = pts.shape[0] // len(devices)
    out = []
    for i, dev in enumerate(devices):
        slab = pts[i * per:(i + 1) * per].to(dev)
        with _device_context(dev):
            for j in range(0, per, chunk):
                p = slab[j:j + chunk]
                d = torch.zeros_like(p)
                d[..., -1] = -1.0
                out.append(field_fn(p[None], d[None])[0])
    return torch.cat([t.to(devices[0]) for t in out])[:n]


@torch.no_grad()
def eval_volume(params, fcfg: fields.FieldConfig, film_geo, film_app,
                points: torch.Tensor, chunk: int = 262144,
                compute_dtype=torch.float32, devices=None) -> torch.Tensor:
    """Field outputs over a point cloud (N, 3) with a locked view direction
    (0, 0, -1), in blocks of `chunk` points, over `devices` in slabs
    (_eval_lattice). Takes the torch route, as the JAX function takes
    XLA's. Returns (N, output_dim)."""
    # texture table once, outside the chunk loop
    params = fields.with_grid_table(
        params, fcfg,
        torch.bfloat16 if compute_dtype == torch.bfloat16 else None)
    here = (params, film_geo, film_app)
    on = _by_device(film_geo[0].device, here, lambda dev: _on(here, dev))

    def field_fn(pts, drs):
        p, fg, fa = on(pts.device)
        return fields.apply_field(p, fcfg, pts, drs, fg, fa,
                                  compute_dtype=compute_dtype)

    return _eval_lattice(field_fn, points, chunk, devices)


@torch.no_grad()
def eval_volume_grid(params, gcfg: lgf.GridFieldConfig, z: torch.Tensor,
                     points: torch.Tensor, chunk: int = 262144,
                     compute_dtype=torch.float32,
                     plane: torch.Tensor | None = None,
                     devices=None) -> torch.Tensor:
    """The latent-grid analogue of eval_volume: field outputs over points
    (N, 3) for z (1, z_dim), the plane computed once per device (or given).
    Returns (N, output_dim)."""
    return _eval_lattice(_grid_field_fn(params, gcfg, z, compute_dtype,
                                        plane), points, chunk, devices)


def eval_volume_sharded(params, fcfg: fields.FieldConfig, film_geo,
                        film_app, points: torch.Tensor, devices,
                        chunk: int = 262144,
                        compute_dtype=torch.float32) -> torch.Tensor:
    """eval_volume(devices=devices): the lattice in len(devices) slabs."""
    return eval_volume(params, fcfg, film_geo, film_app, points, chunk,
                       compute_dtype, devices=devices)


def eval_volume_grid_sharded(params, gcfg: lgf.GridFieldConfig,
                             z: torch.Tensor, points: torch.Tensor, devices,
                             chunk: int = 262144,
                             compute_dtype=torch.float32) -> torch.Tensor:
    """eval_volume_grid(devices=devices): the lattice in slabs."""
    return eval_volume_grid(params, gcfg, z, points, chunk, compute_dtype,
                            devices=devices)
