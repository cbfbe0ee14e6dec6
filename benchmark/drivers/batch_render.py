"""Batch renders, as the FID protocol makes them: batches of `batch` images
from normal latents through models/generator.py::render_truncated (psi
truncation toward the average W, computed in set-up) with a sampled camera
per image, each batch's pixels (every channel) and depth copied to the
host, as fast as they come. The window counts the images whose pixels
reached the host.

Traffic keys: stage_step (the curriculum stage the eval render takes),
img_size, num_steps, ray_chunk, batch, psi, sigma_bias, the camera and
fill (fov, ray_start, ray_end, h_stddev, v_stddev, fill_mode), check_images
(images compared with the reference), trace_batches (batches profiled).
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.harness import compare, core, weights
from benchmark.harness import faults as faultlib
from benchmark.reference import film_field, precision, render as ref_render

KERNELS = ("film_mlp",)


def _program_config(c: dict):
    from fenerf_tpu_torch.nn import fields

    return fields.get_config(
        c["model"], hidden_dim=c["hidden_dim"], trunk_layers=c["trunk_layers"],
        color_layers=c["color_layers"], n_labels=c["n_labels"],
        label_hidden_layers=c["label_hidden_layers"],
        grid_channels=c["grid_channels"],
        grid_resolution=c["grid_resolution"], z_geo_dim=c["z_geo_dim"],
        z_app_dim=c["z_app_dim"], map_hidden_dim=c["map_hidden_dim"])


def make_weights(run):
    w = weights.materialize(weights.film_field(run.config), run.seed,
                            run.device)
    w["sigma_head"]["b"] += float(run.traffic["sigma_bias"])
    return w


def batch_inputs(run, index: int):
    """Latents (B, z) x 2 and the render's draws of batch `index`."""
    t = run.traffic
    b, n, s = t["batch"], t["img_size"], t["num_steps"]
    g = run.inputs_generator(1, index)
    dev = run.device
    zg = torch.randn((b, run.config["z_geo_dim"]), generator=g, device=dev)
    za = torch.randn((b, run.config["z_app_dim"]), generator=g, device=dev)
    jitter = torch.rand((b, n * n, s), generator=g, device=dev)
    cam_h = torch.randn((b, 1), generator=g, device=dev)
    cam_v = torch.randn((b, 1), generator=g, device=dev)
    u = torch.rand((b, n * n, s), generator=g, device=dev)
    return zg, za, ref_render.Draws(jitter, u, cam_h, cam_v)


def render_spec(t: dict) -> ref_render.RenderSpec:
    return ref_render.RenderSpec(
        img_size=t["img_size"], num_steps=t["num_steps"], fov=t["fov"],
        ray_start=t["ray_start"], ray_end=t["ray_end"],
        h_stddev=t["h_stddev"], v_stddev=t["v_stddev"],
        fill_mode=t["fill_mode"])


def setup(run):
    from fenerf_tpu_torch.models import generator as gen
    from fenerf_tpu_torch.nn import fields
    from fenerf_tpu_torch.ops import build, film_mlp
    from fenerf_tpu_torch.train.curriculum import get_curriculum

    t = run.traffic
    dev = torch.device(run.device)
    fcfg = _program_config(run.config)
    if dev.type == "cuda":
        with core.phase(run, "kernel build or load check"):
            build.build(KERNELS)
    meta = get_curriculum(run.config["curriculum"]).at_step(t["stage_step"])
    rcfg = meta.eval_render_config(
        img_size=t["img_size"], num_steps=t["num_steps"],
        ray_chunk=t["ray_chunk"], backend=film_mlp.backend_for(fcfg, dev))
    spec = render_spec(t)
    for key in ("fov", "ray_start", "ray_end", "h_stddev", "v_stddev",
                "fill_mode"):
        if getattr(rcfg, key) != getattr(spec, key):
            raise ValueError(f"the program's eval render has {key} "
                             f"{getattr(rcfg, key)!r}, the traffic "
                             f"{getattr(spec, key)!r}")
    with core.phase(run, "weights"):
        params = make_weights(run)
    with torch.no_grad(), core.phase(run, "avg_film"):
        avg = fields.avg_film(params, fcfg, run.inputs_generator(0))

    def render_batch(index):
        zg, za, d = batch_inputs(run, index)
        draws = gen.RenderDraws(d.jitter, d.cam_h, d.cam_v,
                                gen.RayNoise(d.u, None, None))
        with torch.no_grad(), record_function("bench/render"):
            out = gen.render_truncated(params, fcfg, rcfg, zg, za, avg,
                                       psi=t["psi"], draws=draws)
        with record_function("bench/host_copy"):
            return out["pixels"].float().cpu(), out["depth"].float().cpu()

    with core.phase(run, "warm-up batch"):
        render_batch(-1)      # the cell's one shape
    run.state.update(params=params, render_batch=render_batch)
    run.facts.update(kind="render", rays_per_image=t["img_size"] ** 2,
                     samples=2 * t["num_steps"])


def window(run, seconds):
    render_batch = run.state["render_batch"]
    limit = run.traffic["trace_batches"] if run.trace else None
    kept = []
    t0 = time.monotonic()
    while True:
        kept.append(render_batch(len(kept)))
        if (time.monotonic() - t0 >= seconds
                or (limit is not None and len(kept) >= limit)):
            break
    elapsed = time.monotonic() - t0
    images = len(kept) * run.traffic["batch"]
    run.attempted = images
    run.state["outputs"] = kept
    run.facts.update(images=images, window_s=elapsed)
    return {"render_img_per_s": images / elapsed}


def release(run):
    run.facts["outputs"] = run.state.pop("outputs")


def reference_images(run, picks, prec):
    """The reference's pixels and depth of images `picks` [(batch, row)]."""
    t = run.traffic
    w = make_weights(run)
    spec = render_spec(t)
    out = []
    with torch.no_grad(), precision.exact_float32():
        for bi, row in picks:
            zg, za, d = batch_inputs(run, bi)
            films = film_field.film(w, zg[row:row + 1], za[row:row + 1], prec)
            if t["psi"] != 1.0:
                avg = film_field.avg_film(w, run.inputs_generator(0),
                                          prec=prec)
                films = film_field.truncate(films, avg, t["psi"])
            one = ref_render.Draws(*(x[row:row + 1] for x in d))
            res = ref_render.render(
                lambda p, dr: film_field.field(w, p, dr, *films, prec=prec),
                spec, one, 1, ray_chunk=t["ray_chunk"], device=run.device)
            out.append((res["pixels"][0].cpu().numpy(),
                        res["depth"][0].cpu().numpy()))
    return out


def picks_of(run) -> list:
    b = run.traffic["batch"]
    outputs = run.facts["outputs"]
    rng = np.random.default_rng([run.seed % 2 ** 63, 2])
    idx = compare.sample(rng, len(outputs) * b, run.traffic["check_images"])
    return [(i // b, i % b) for i in idx]


def check(run, prec=None) -> list:
    prec = prec or run.reference
    picks = picks_of(run)
    outputs = run.facts["outputs"]
    ref = reference_images(run, picks, prec)
    pairs = [(outputs[bi][0][row].numpy(), rp, outputs[bi][1][row].numpy(),
              rd) for (bi, row), (rp, rd) in zip(picks, ref)]
    gaps = compare.render_gaps(pairs)
    limits = run.cell["limits"]
    return [core.Check(k, gaps[k], float(limits[k])) for k in sorted(limits)]


def control(run, prec) -> dict:
    """The gaps when the reference computed at `prec` stands in the
    program's place, over images of the run's first four batches."""
    b = run.traffic["batch"]
    rng = np.random.default_rng([run.seed % 2 ** 63, 2])
    idx = compare.sample(rng, 4 * b, run.traffic["check_images"])
    picks = [(i // b, i % b) for i in idx]
    low = reference_images(run, picks, prec)
    ref = reference_images(run, picks, run.reference)
    return compare.render_gaps([(lp, rp, ld, rd) for (lp, ld), (rp, rd)
                                in zip(low, ref)])


def _half_batch(fn):
    """render_truncated on the first half of the batch, its images standing
    for the rest."""
    from fenerf_tpu_torch.models import generator as gen

    def wrapped(params, fcfg, rcfg, z_geo, z_app, avg, psi=0.7,
                noise_std=0.0, camera=None, generator=None, draws=None):
        b = z_geo.shape[0] // 2
        cut = lambda t: None if t is None else t[:b]
        half = gen.RenderDraws(cut(draws.jitter), cut(draws.cam_h),
                               cut(draws.cam_v),
                               gen.RayNoise(*(cut(t) for t in draws.noise)))
        out = fn(params, fcfg, rcfg, z_geo[:b], z_app[:b], avg, psi,
                 noise_std, camera, generator, half)
        return {k: torch.cat([v, v]) for k, v in out.items()}
    return wrapped


def faults() -> dict:
    from fenerf_tpu_torch.models import generator as gen

    return {"answer_altered": faultlib.planted(gen, "render_truncated",
                                               faultlib.altered_pixels),
            "half_batch": faultlib.planted(gen, "render_truncated",
                                           _half_batch)}
