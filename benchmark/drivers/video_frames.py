"""Video frames, as apps/render_video.py renders them: a camera trajectory
of `num_frames` frames, the latent interpolated between two seeds along
it, each frame rendered by render_video.frame_renderer's render_frame and
its pixels and depth copied to the host, one frame after another; then the
next video, with the next pair of seeds, until the window closes. Every
frame of the run takes the same draws (one generator), as the CLI renders
every frame from one key. The window counts the frames that reached the
host.

Traffic keys: img_size, num_steps, ray_chunk, num_frames, trajectory
("front"), latent_type ("geo"), psi, fill_mode, fill_color, fill_rgb
(the fill an RGB-only family's frames take), sigma_bias,
check_frames (frames compared with the reference), trace_frames (frames
profiled).
"""
from __future__ import annotations

import math
import time
import types

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.harness import compare, core, weights
from benchmark.harness import faults as faultlib
from benchmark.reference import grid_field, precision, render as ref_render


def trajectory(name: str, frames: int, base_fov: float = 12.0) -> list:
    """(t, pitch, yaw, fov) of each frame (the published video script's
    'front' path: a small ellipse with a breathing field of view)."""
    if name != "front":
        raise ValueError(f"unknown trajectory {name!r}")
    out = []
    for t in np.linspace(0, 1, frames, endpoint=True):
        a = t * 2 * math.pi
        out.append((float(t), float(0.2 * np.cos(a) + math.pi / 2),
                    float(0.4 * np.sin(a) + math.pi / 2),
                    float(base_fov + 5 + np.sin(a) * 5)))
    return out


def make_weights(run):
    w = weights.materialize(weights.grid_field(run.config), run.seed,
                            run.device)
    w["sigma_head"]["b"] += float(run.traffic["sigma_bias"])
    return w


def _program_config(c: dict):
    from fenerf_tpu_torch.nn import latent_grid_field as lgf

    return lgf.get_grid_config(
        c["model"], z_dim=c["z_dim"], hidden_dim=c["hidden_dim"],
        trunk_layers=c["trunk_layers"], grid_res=c["grid_res"],
        grid_ch=c["grid_ch"], ch_max=c["ch_max"],
        map_hidden_dim=c["map_hidden_dim"])


def frame_inputs(run, index: int):
    """Frame `index` of the run: its latent (1, z), camera (pitch, yaw,
    fov); the run's draws come from frame_draws."""
    t = run.traffic
    video, k = divmod(index, t["num_frames"])
    tt, pitch, yaw, fov = trajectory(t["trajectory"], t["num_frames"])[k]

    def z(which):
        g = run.inputs_generator(3, video, which)
        return torch.randn((1, run.config["z_dim"]), generator=g,
                           device=run.device)

    # the 'geo' interpolation lerps the one latent between the seeds
    z_t = z(0) * (1 - tt) + z(1) * tt
    return z_t, (pitch, yaw, fov)


def frame_draws(run) -> ref_render.Draws:
    t = run.traffic
    n, s = t["img_size"], t["num_steps"]
    g = run.inputs_generator(4)
    jitter = torch.rand((1, n * n, s), generator=g, device=run.device)
    u = torch.rand((1, n * n, s), generator=g, device=run.device)
    return ref_render.Draws(jitter, u)


def setup(run):
    from fenerf_tpu_torch.apps import render_video
    from fenerf_tpu_torch.apps.common import best_backend
    from fenerf_tpu_torch.models import generator as gen

    t = run.traffic
    dev = torch.device(run.device)
    gcfg = _program_config(run.config)
    args = types.SimpleNamespace(
        image_size=t["img_size"], num_steps=t["num_steps"],
        fill_mode=t["fill_mode"], fill_color=t["fill_color"],
        ray_chunk=t["ray_chunk"])
    rcfg = render_video.render_config(args, gcfg, best_backend(gcfg, dev))
    if rcfg.fill_mode != t["fill_rgb"]:
        raise ValueError(f"the program fills {rcfg.fill_mode!r}, the "
                         f"traffic states {t['fill_rgb']!r}")
    with core.phase(run, "weights"):
        params = make_weights(run)
    with core.phase(run, "frame_renderer"):
        _, render_frame = render_video.frame_renderer(params, gcfg, rcfg,
                                                      t["psi"], dev)
    d = frame_draws(run)
    draws = gen.RenderDraws(d.jitter, None, None,
                            gen.RayNoise(d.u, None, None))

    def one_frame(index):
        z, camera = frame_inputs(run, index)
        with torch.no_grad(), record_function("bench/render"):
            out = render_frame((z, z), (z, z), camera, draws)
        with record_function("bench/host_copy"):
            return out["pixels"][0].float().cpu(), out["depth"][0].float().cpu()

    with core.phase(run, "warm-up frame"):
        one_frame(0)          # the cell's one shape
    run.state.update(params=params, one_frame=one_frame)
    run.facts.update(kind="render", rays_per_image=t["img_size"] ** 2,
                     samples=2 * t["num_steps"])


def window(run, seconds):
    one_frame = run.state["one_frame"]
    limit = run.traffic["trace_frames"] if run.trace else None
    kept = []
    t0 = time.monotonic()
    while True:
        kept.append(one_frame(len(kept)))
        if (time.monotonic() - t0 >= seconds
                or (limit is not None and len(kept) >= limit)):
            break
    elapsed = time.monotonic() - t0
    run.attempted = len(kept)
    run.state["outputs"] = kept
    run.facts.update(images=len(kept), window_s=elapsed)
    return {"render_img_per_s": len(kept) / elapsed}


def release(run):
    run.facts["outputs"] = run.state.pop("outputs")


def reference_frames(run, picks, prec):
    t = run.traffic
    w = make_weights(run)
    spec = ref_render.RenderSpec(img_size=t["img_size"],
                                 num_steps=t["num_steps"],
                                 fill_mode=t["fill_rgb"])
    draws = frame_draws(run)
    out = []
    with torch.no_grad(), precision.exact_float32():
        for i in picks:
            z, camera = frame_inputs(run, i)
            pl = grid_field.plane(w, z, prec.mapping)
            res = ref_render.render(
                lambda p, d: grid_field.field(
                    w, p, d, pl, prec, grid_res=run.config["grid_res"]),
                spec, draws, 1, camera=camera, ray_chunk=t["ray_chunk"],
                device=run.device)
            out.append((res["pixels"][0].cpu().numpy(),
                        res["depth"][0].cpu().numpy()))
    return out


def check(run, prec=None) -> list:
    prec = prec or run.reference
    outputs = run.facts["outputs"]
    rng = np.random.default_rng([run.seed % 2 ** 63, 5])
    picks = compare.sample(rng, len(outputs), run.traffic["check_frames"])
    ref = reference_frames(run, picks, prec)
    pairs = [(outputs[i][0].numpy(), rp, outputs[i][1].numpy(), rd)
             for i, (rp, rd) in zip(picks, ref)]
    gaps = compare.render_gaps(pairs)
    limits = run.cell["limits"]
    return [core.Check(k, gaps[k], float(limits[k])) for k in sorted(limits)]


def control(run, prec) -> dict:
    """The gaps when the reference computed at `prec` stands in the
    program's place, over frames of the run's first video."""
    rng = np.random.default_rng([run.seed % 2 ** 63, 5])
    picks = compare.sample(rng, run.traffic["num_frames"],
                           run.traffic["check_frames"])
    low = reference_frames(run, picks, prec)
    ref = reference_frames(run, picks, run.reference)
    return compare.render_gaps([(lp, rp, ld, rd) for (lp, ld), (rp, rd)
                                in zip(low, ref)])


def faults() -> dict:
    from fenerf_tpu_torch.models import generator as gen

    return {"answer_altered": faultlib.planted(gen, "render_grid_from_z",
                                               faultlib.altered_pixels)}
