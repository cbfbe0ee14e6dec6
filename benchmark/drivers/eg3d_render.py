"""Batch renders of EG3D's tri-plane generator, as an FID job or a sample
sheet makes them: batches of `batch` images from normal z, one pose per
image drawn from the traffic's spreads and used both as the conditioning
label c and as the render camera, through models/generator.py::render_eg3d
(mapping, the backbone's planes, the 128^2 feature image, super-resolution
to 512^2); each batch's image, raw image and depth copied to the host, as
fast as they come. The window counts the images that reached the host.

Traffic keys: img_size (the neural rendering's), num_steps (stratified; as
many importance samples), ray_chunk, batch, psi, h_stddev, v_stddev
(spreads of yaw and pitch about pi/2), truncate (the normals' bound, in
standard deviations), noise_std (of the noise strengths the weights draw),
sigma_bias, check_images (images compared with the reference),
trace_batches (batches profiled).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.drivers import batch_render
from benchmark.harness import compare, core
from benchmark.reference import eg3d as ref
from benchmark.reference import precision

SIZES = ("z_dim", "c_dim", "w_dim", "map_depth", "plane_res", "plane_ch",
         "channel_base", "channel_max", "decoder_hidden", "sr_in",
         "box_warp")


def sizes(c: dict) -> ref.Sizes:
    return ref.Sizes(**{k: c[k] for k in SIZES},
                     sr_channels=tuple(c["sr_channels"]))


def spec(run) -> ref.RenderSpec:
    t, c = run.traffic, run.config
    return ref.RenderSpec(img_size=t["img_size"], num_steps=t["num_steps"],
                          ray_start=c["ray_start"], ray_end=c["ray_end"],
                          ray_chunk=t["ray_chunk"])


def make_state(run) -> dict:
    """The seed's TriPlaneGenerator state_dict (EG3D's names), made on the
    device; the density output's bias raised by sigma_bias."""
    t = run.traffic
    sd = ref.init_state(run.inputs_generator(0), sizes(run.config),
                        run.device, noise_std=t["noise_std"])
    sd["decoder.net.2.bias"][0] += float(t["sigma_bias"])
    return sd


def _truncated(g, shape, bound, device):
    """Standard normals truncated to [-bound, bound] by the inverse CDF."""
    cdf = lambda x: 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))
    lo, hi = cdf(-bound), cdf(bound)
    u = torch.rand(shape, generator=g, device=device)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
    return x.clamp(-bound, bound)


def batch_inputs(run, index: int):
    """z (B, z_dim), the label c (B, 25), jitter and uniforms (B, R, S)."""
    t, c = run.traffic, run.config
    b, n, s = t["batch"], t["img_size"], t["num_steps"]
    g = run.inputs_generator(1, index)
    dev = run.device
    z = torch.randn((b, c["z_dim"]), generator=g, device=dev)
    yaw = math.pi / 2 + t["h_stddev"] * _truncated(g, (b, 1), t["truncate"],
                                                    dev)
    pitch = math.pi / 2 + t["v_stddev"] * _truncated(g, (b, 1),
                                                     t["truncate"], dev)
    label = ref.label(ref.cam2world(yaw, pitch, c["camera_radius"],
                                    tuple(c["camera_pivot"])), c["focal"])
    jitter = torch.rand((b, n * n, s), generator=g, device=dev)
    u = torch.rand((b, n * n, s), generator=g, device=dev)
    return z, label, jitter, u


def program_config(c: dict):
    from fenerf_tpu_torch.nn import triplane_field as tpf

    return tpf.get_triplane_config(
        c["model"], **{k: c[k] for k in SIZES},
        sr_channels=tuple(c["sr_channels"]),
        decoder_lr_mul=c["decoder_lr_mul"])


def setup(run):
    from fenerf_tpu_torch.models import generator as gen
    from fenerf_tpu_torch.nn import triplane_field as tpf

    t, c = run.traffic, run.config
    cfg = program_config(c)
    if cfg.img_size != c["img_resolution"]:
        raise ValueError(f"the program's output is {cfg.img_size}^2, the "
                         f"configuration's {c['img_resolution']}^2")
    rcfg = gen.eg3d_render_config(
        img_size=t["img_size"], num_steps=t["num_steps"],
        ray_chunk=t["ray_chunk"], ray_start=c["ray_start"],
        ray_end=c["ray_end"])
    with core.phase(run, "weights"):
        params = tpf.params_from_eg3d(make_state(run), cfg, run.device)

    def render_batch(index):
        z, label, jitter, u = batch_inputs(run, index)
        draws = gen.RenderDraws(jitter, None, None,
                                gen.RayNoise(u, None, None))
        with torch.no_grad(), record_function("bench/render"):
            out = gen.render_eg3d(params, cfg, rcfg, z, label, psi=t["psi"],
                                  draws=draws)
        with record_function("bench/host_copy"):
            return tuple(out[k].float().cpu()
                         for k in ("image", "image_raw", "depth"))

    with core.phase(run, "warm-up batch"):
        render_batch(-1)      # the cell's one shape
    run.state.update(params=params, render_batch=render_batch)
    run.facts.update(kind="render", rays_per_image=t["img_size"] ** 2,
                     samples=2 * t["num_steps"])


# batch_render's window (the images of whole batches that reached the
# host) and release
window, release = batch_render.window, batch_render.release


def reference_images(run, picks, prec):
    """The reference's (image, image_raw, depth) of images `picks`
    [(batch, row)], one image at a time."""
    if run.traffic["psi"] != 1.0:
        raise ValueError("the reference generates at psi 1")
    sd = make_state(run)
    s, rs = sizes(run.config), spec(run)
    out = []
    with precision.exact_float32():
        for bi, row in picks:
            one = [x[row:row + 1] for x in batch_inputs(run, bi)]
            res = ref.generate(sd, s, rs, *one, prec=prec)
            out.append(tuple(res[k][0].cpu().numpy()
                             for k in ("image", "image_raw", "depth")))
    return out


def _pairs(prog, refs):
    """(pixels, reference pixels, depth, reference depth): the pixels of
    the 512^2 image and of the raw image together."""
    pix = lambda im, raw: np.concatenate([np.ravel(im), np.ravel(raw)])
    return [(pix(p[0], p[1]), pix(r[0], r[1]), p[2], r[2])
            for p, r in zip(prog, refs)]


def picks_of(run, n_batches: int) -> list:
    b = run.traffic["batch"]
    rng = np.random.default_rng([run.seed % 2 ** 63, 2])
    idx = compare.sample(rng, n_batches * b, run.traffic["check_images"])
    return [(i // b, i % b) for i in idx]


def check(run, prec=None) -> list:
    prec = prec or run.reference
    outputs = run.facts["outputs"]
    picks = picks_of(run, len(outputs))
    prog = [tuple(t[row].numpy() for t in outputs[bi]) for bi, row in picks]
    gaps = compare.render_gaps(_pairs(prog, reference_images(run, picks,
                                                             prec)))
    limits = run.cell["limits"]
    return [core.Check(k, gaps[k], float(limits[k])) for k in sorted(limits)]


def control(run, prec) -> dict:
    """The gaps when the reference computed at `prec` stands in the
    program's place, over images of the run's first four batches."""
    picks = picks_of(run, 4)
    low = reference_images(run, picks, prec)
    return compare.render_gaps(_pairs(low, reference_images(
        run, picks, run.reference)))


def _altered(fn):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        return {**out, "image": out["image"] + 0.5}
    return wrapped


def _half_batch(fn):
    """render_eg3d on the first half of the batch, its images standing for
    the rest."""
    from fenerf_tpu_torch.models import generator as gen

    def wrapped(params, cfg, rcfg, z, c, camera=None, psi=1.0,
                generator=None, draws=None):
        b = z.shape[0] // 2
        cut = lambda t: None if t is None else t[:b]
        half = gen.RenderDraws(cut(draws.jitter), None, None,
                               gen.RayNoise(cut(draws.noise.u), None, None))
        out = fn(params, cfg, rcfg, z[:b], c[:b], cut(camera), psi,
                 generator, half)
        return {k: torch.cat([v, v]) for k, v in out.items()}
    return wrapped


def faults() -> dict:
    from benchmark.harness import faults as faultlib
    from fenerf_tpu_torch.models import generator as gen

    return {"answer_altered": faultlib.planted(gen, "render_eg3d", _altered),
            "half_batch": faultlib.planted(gen, "render_eg3d", _half_batch)}
