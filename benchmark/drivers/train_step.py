"""Training steps of the film family, as train/loop.py::train_step runs
them: one object (the networks, their Adam states and EMAs, made from the
seed's weights by train_state_from_params) driven step after step, each
step on its own reals and draws made from the seed. Set-up runs the first
`follow_steps` - 1 steps through the window's own call (the warm-up); the
window runs the next ones until --seconds ran out and ends at the
synchronize after the last. The window counts the real images the steps
consumed.

The reference follows the first `follow_steps` steps from the seed's
weights, the last of them the window's first: set-up keeps step 1's
renders, losses and gradients; the window keeps its first step's losses
and a copy of the state after it, into device buffers made in set-up
(parameters, EMAs, Adam's first moments, which with beta1 = 0 are that
step's clipped gradients).

Traffic keys: stage_step (the global step of the stage's first followed
step: the curriculum stage, its batch, split, size, samples, learning
rates), stage_start (the stage's first step: the fade-in's clock), batch,
batch_split, img_size, num_steps, the stage's optimisation constants
(gen_lr, disc_img_lr, disc_seg_lr, betas, grad_clip, r1_lambda,
pos_lambda, g_seg_lambda, mapping_lr_mult, fade_steps, topk_interval,
topk_v, n_labels), follow_steps (steps the reference repeats),
ref_ray_chunk, trace_steps (steps profiled).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from benchmark.harness import compare, core, weights
from benchmark.harness import faults as faultlib
from benchmark.reference import precision, render as ref_render
from benchmark.reference import train_step as ref

KERNELS = ("film_mlp", "film_mlp_bwd", "zexp_fold")
STAGE_KEYS = {"batch": "batch_size", "batch_split": "batch_split",
              "img_size": "img_size", "num_steps": "num_steps",
              "gen_lr": "gen_lr", "disc_img_lr": "disc_img_lr",
              "disc_seg_lr": "disc_seg_lr", "grad_clip": "grad_clip",
              "r1_lambda": "r1_lambda", "pos_lambda": "pos_lambda",
              "g_seg_lambda": "g_seg_loss_lambda",
              "mapping_lr_mult": "mapping_lr_mult",
              "fade_steps": "fade_steps", "topk_interval": "topk_interval",
              "topk_v": "topk_v"}


def networks(run):
    """(G, D_img, D_seg) from the seed, made by the benchmark."""
    c = run.config
    tag = lambda k: (run.seed * 1_000_003 + k) % 2 ** 63
    head = 1 + c["z_geo_dim"] + c["z_app_dim"] + 2
    return (weights.materialize(weights.film_field(c), tag(1), run.device),
            weights.materialize(weights.critic(3, head), tag(2), run.device),
            weights.materialize(weights.critic(c["n_labels"] + 3, head),
                                tag(3), run.device))


def scalars(t: dict, k: int):
    """(alpha, topk fraction) of followed step k (1-based): the fade-in
    from the stage's start and the top-k schedule at the global step; the
    density noise has annealed to 0 by this stage."""
    step = t["stage_step"] + k - 1
    alpha = min(1.0, (step - t["stage_start"]) / t["fade_steps"])
    frac = max(0.99 ** (step / t["topk_interval"]), t["topk_v"])
    return alpha, frac


def reals(g, b, size, n_labels, dev):
    """Images in [-1, 1] (smooth colour fields from 4 x 4 noise) and one-hot
    label maps (argmax of 8 x 8 noise) x 2 - 1."""
    up = lambda t: F.interpolate(t, size=(size, size), mode="bilinear",
                                 align_corners=False)
    imgs = up(torch.rand(b, 3, 4, 4, generator=g, device=dev) * 2 - 1)
    lab = up(torch.rand(b, n_labels, 8, 8, generator=g, device=dev)).argmax(1)
    labels = F.one_hot(lab, n_labels).permute(0, 3, 1, 2)
    return imgs.clamp(-1, 1), labels.float() * 2 - 1


def step_inputs(run, k: int):
    """Reals, labels and every draw of step k."""
    t, c, dev = run.traffic, run.config, run.device
    g = run.inputs_generator(7, k)
    b, s, n = t["batch"], t["batch_split"], t["img_size"]
    imgs, labels = reals(g, b, n, t["n_labels"], dev)

    def z():
        return (torch.randn((b, c["z_geo_dim"]), generator=g, device=dev),
                torch.randn((b, c["z_app_dim"]), generator=g, device=dev))

    def renders():
        shape = (b // s, n * n, t["num_steps"])
        out = []
        for _ in range(s):
            jitter = torch.rand(shape, generator=g, device=dev)
            cam_h = torch.randn((b // s, 1), generator=g, device=dev)
            cam_v = torch.randn((b // s, 1), generator=g, device=dev)
            u = torch.rand(shape, generator=g, device=dev)
            out.append(ref_render.Draws(jitter, u, cam_h, cam_v))
        return out

    draws = {"z_img": z(), "fakes_img": renders(), "z_seg": z(),
             "fakes_seg": renders(), "z_g": z(), "g_renders": renders()}
    return imgs, labels, draws


def _meta(run):
    from fenerf_tpu_torch.train.curriculum import get_curriculum

    c, t = run.config, run.traffic
    meta = get_curriculum(c["curriculum"]).at_step(t["stage_step"])
    fields = ("hidden_dim", "map_hidden_dim", "grid_resolution",
              "grid_channels")
    meta = dataclasses.replace(
        meta, batch_size=t["batch"], batch_split=t["batch_split"],
        img_size=t["img_size"], num_steps=t["num_steps"],
        latent_geo_dim=c["z_geo_dim"], latent_app_dim=c["z_app_dim"],
        field_overrides=tuple((k, c[k]) for k in fields))
    for key, attr in STAGE_KEYS.items():
        if float(getattr(meta, attr)) != float(t[key]):
            raise ValueError(f"the curriculum's stage has {attr} "
                             f"{getattr(meta, attr)!r}, the traffic "
                             f"{key} {t[key]!r}")
    if tuple(meta.betas) != tuple(t["betas"]):
        raise ValueError(f"betas {meta.betas} != {t['betas']}")
    return meta


def _program_draws(draws):
    from fenerf_tpu_torch.models import generator as gen
    from fenerf_tpu_torch.train.loop import StepDraws

    rd = lambda d: gen.RenderDraws(d.jitter, d.cam_h, d.cam_v,
                                   gen.RayNoise(d.u, None, None))
    return StepDraws(draws["z_img"], [rd(d) for d in draws["fakes_img"]],
                     draws["z_seg"], [rd(d) for d in draws["fakes_seg"]],
                     draws["z_g"], [rd(d) for d in draws["g_renders"]])


def _host(tree):
    """A copy of each leaf on the host, {path: tensor}."""
    return {p: t.detach().to("cpu", torch.float32, copy=True)
            for p, t in flat(tree).items()}


def flat(tree, path=()) -> dict:
    """{path: tensor} of a tree, dict keys sorted."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, path + (i,)))
        return out
    return {path: tree}


@contextlib.contextmanager
def _recorded(sink: list):
    """Every render of the block (the program's generator.render_any, which
    train_step calls for each microbatch of D_img, D_seg and G) has its
    pixels copied to the host into `sink`, in order."""
    from fenerf_tpu_torch.models import generator as gen

    def record(fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            sink.append(out["pixels"].detach().float().cpu())
            return out
        return wrapped

    with faultlib.planted(gen, "render_any", record)():
        yield


def setup(run):
    from fenerf_tpu_torch.ops import build
    from fenerf_tpu_torch.train import loop

    t = run.traffic
    dev = torch.device(run.device)
    if dev.type == "cuda":
        with core.phase(run, "kernel build or load check"):
            build.build(KERNELS)
    meta = _meta(run)
    with core.phase(run, "weights and state"):
        g, d_img, d_seg = networks(run)
        state = loop.train_state_from_params(meta, g, d_img, d_seg)
    run.state.update(state=state)

    def one_step(k):
        imgs, labels, draws = step_inputs(run, k)
        alpha, frac = scalars(t, k)
        with record_function("bench/train_step"):
            run.state["state"], metrics = loop.train_step(
                run.state["state"], imgs, labels,
                loop.StepScalars(alpha, 0.0, frac), meta,
                draws=_program_draws(draws))
        return metrics

    fakes = []
    with _recorded(fakes), core.phase(run, "warm-up step"):
        m = one_step(1)
    st = run.state["state"]
    run.facts.update(
        kind="train", losses=[_losses(m)], fakes=fakes,
        grads=[{"g": _host(st.opt_g.mu), "d_img": _host(st.opt_img.mu),
                "d_seg": _host(st.opt_seg.mu)}],
        g_rows_per_step=t["batch"] * t["img_size"] ** 2 * 2 * t["num_steps"])
    for k in range(2, t["follow_steps"]):
        one_step(k)
    buffers = {group: {net: {p: torch.empty_like(x) for p, x in leaves.items()}
                       for net, leaves in nets.items()}
               for group, nets in _compared(st).items()}
    run.state.update(one_step=one_step, next=t["follow_steps"],
                     buffers=buffers)


def _losses(metrics) -> dict:
    return {n: float(metrics[n]) for n in ("d_img_loss", "d_seg_loss",
                                           "g_loss")}


def _compared(st) -> dict:
    """What the check compares after a step: {group: {net: {path: t}}}."""
    return {"after": {"g": flat(st.g_params), "d_img": flat(st.d_img_params),
                      "d_seg": flat(st.d_seg_params),
                      "ema": flat(st.ema.params),
                      "ema2": flat(st.ema2.params)},
            "grads": {"g": flat(st.opt_g.mu), "d_img": flat(st.opt_img.mu),
                      "d_seg": flat(st.opt_seg.mu)}}


def _copy_into(buffers: dict, st) -> None:
    """Copies what the check compares into buffers made in set-up, so the
    window allocates nothing for it."""
    for group, nets in _compared(st).items():
        for net, leaves in nets.items():
            for p, t in leaves.items():
                buffers[group][net][p].copy_(t)


def window(run, seconds):
    one_step, k = run.state["one_step"], run.state["next"]
    limit = run.traffic["trace_steps"] if run.trace else None
    t0 = time.monotonic()
    # the window's first step is the last one the reference follows
    first = one_step(k)
    _copy_into(run.state["buffers"], run.state["state"])
    run.state["followed"] = (first, run.state.pop("buffers"))
    steps = 1
    ends = [time.monotonic() - t0]
    while (time.monotonic() - t0 < seconds
           and (limit is None or steps < limit)):
        one_step(k + steps)
        steps += 1
        ends.append(time.monotonic() - t0)
    if torch.device(run.device).type == "cuda":
        torch.cuda.synchronize()
    elapsed = time.monotonic() - t0
    images = steps * run.traffic["batch"]
    run.attempted = images
    run.facts.update(steps=steps, images=images, window_s=elapsed)
    core.note(run, "window steps %d, host seconds at each step's end %s"
              % (steps, [round(e, 3) for e in ends]))
    return {"train_img_per_s": images / elapsed}


def release(run):
    """The window's first step's losses, its gradients and the state after
    it, to the host; the program's state goes."""
    metrics, snap = run.state.pop("followed")
    run.facts["losses"].append(_losses(metrics))
    run.facts["grads"].append({n: {p: t.to("cpu", torch.float32)
                                   for p, t in v.items()}
                               for n, v in snap["grads"].items()})
    run.facts["after"] = {n: {p: t.to("cpu", torch.float32)
                              for p, t in v.items()}
                          for n, v in snap["after"].items()}


def hyper(t: dict) -> ref.Hyper:
    spec = ref_render.RenderSpec(img_size=t["img_size"],
                                 num_steps=t["num_steps"], fov=t["fov"],
                                 ray_start=t["ray_start"],
                                 ray_end=t["ray_end"],
                                 h_stddev=t["h_stddev"],
                                 v_stddev=t["v_stddev"])
    return ref.Hyper(batch=t["batch"], split=t["batch_split"], spec=spec,
                     gen_lr=t["gen_lr"], disc_img_lr=t["disc_img_lr"],
                     disc_seg_lr=t["disc_seg_lr"], betas=tuple(t["betas"]),
                     grad_clip=t["grad_clip"], r1_lambda=t["r1_lambda"],
                     pos_lambda=t["pos_lambda"],
                     g_seg_lambda=t["g_seg_lambda"],
                     mapping_lr_mult=t["mapping_lr_mult"],
                     ray_chunk=t["ref_ray_chunk"])


def follow(run, prec) -> dict:
    """The reference's readings over the followed steps: step 1's renders,
    the losses and clipped gradients of step 1 and of the last followed
    step (the window's first), the parameters and EMAs after it."""
    t = run.traffic
    hp = hyper(t)
    g, d_img, d_seg = networks(run)
    init = {"g": _host(g), "d_img": _host(d_img), "d_seg": _host(d_seg)}
    state = ref.State(g, d_img, d_seg, hp)
    last = t["follow_steps"]
    losses, grads, fakes = [], [], []
    with precision.exact_float32():
        for k in range(1, last + 1):
            imgs, labels, draws = step_inputs(run, k)
            alpha, frac = scalars(t, k)
            lk, gk = ref.step(state, imgs, labels, draws, alpha, frac, hp,
                              prec, record=fakes if k == 1 else None)
            if k in (1, last):
                losses.append(lk)
                grads.append({n: _host(v) for n, v in gk.items()})
    after = {"g": _host(state.g), "d_img": _host(state.d_img),
             "d_seg": _host(state.d_seg), "ema": _host(state.ema.params),
             "ema2": _host(state.ema2.params)}
    return {"losses": losses, "grads": grads, "after": after, "init": init,
            "fakes": fakes}


def gaps(prog: dict, refr: dict) -> dict:
    """Over step 1 and the window's first step (the last followed):
    loss_gap, the widest relative gap of the two critic losses (the
    generator's loss follows the critics' update and its top-k choice,
    which rounding flips from seed to seed); grad_gap_d and grad_gap_g, of
    the clipped gradient's norm, leaf by leaf, of the critics and of the
    generator. change_gap: of the parameters' and EMAs' change from the
    seed's weights to after the window's first step, leaf by leaf (leaves
    whose reference gradient is under a thousandth of the median leaf's in
    every compared step left out). fake_pixel_rms: the root mean square
    gap of step 1's renders (every microbatch of D_img's, D_seg's and G's
    fakes, every channel)."""
    if len(prog["losses"]) != len(refr["losses"]):
        raise ValueError("the program and the reference compared "
                         "different steps")
    loss_gap = max(abs(p[n] - r[n]) / abs(r[n])
                   for p, r in zip(prog["losses"], refr["losses"])
                   for n in ("d_img_loss", "d_seg_loss"))
    grad = {"g": 0.0, "d_img": 0.0, "d_seg": 0.0}
    keep = {n: set() for n in grad}
    for gp, gr in zip(prog["grads"], refr["grads"]):
        for net in grad:
            gap, kept = compare.leaf_norm_gap(gp[net], gr[net])
            grad[net] = max(grad[net], gap)
            keep[net].update(kept)
    keep["ema"] = keep["ema2"] = keep["g"]
    change_gap = 0.0
    for net in ("g", "d_img", "d_seg", "ema", "ema2"):
        base = refr["init"]["g" if net.startswith("ema") else net]
        dp = {p: prog["after"][net][p] - base[p] for p in keep[net]}
        dr = {p: refr["after"][net][p] - base[p] for p in keep[net]}
        change_gap = max(change_gap, compare.leaf_norm_gap(dp, dr)[0])
    diff = torch.cat([(p - r).double().ravel()
                      for p, r in zip(prog["fakes"], refr["fakes"])])
    fake_rms = float(diff.pow(2).mean().sqrt())
    if len(prog["fakes"]) != len(refr["fakes"]) or not diff.isfinite().all():
        fake_rms = float("inf")
    return {"fake_pixel_rms": fake_rms, "loss_gap": loss_gap,
            "grad_gap_d": max(grad["d_img"], grad["d_seg"]),
            "grad_gap_g": grad["g"], "change_gap": change_gap}


def check(run, prec=None) -> list:
    prec = prec or run.reference
    g = gaps(run.facts, follow(run, prec))
    limits = run.cell["limits"]
    return [core.Check(k, g[k], float(limits[k])) for k in sorted(limits)]


def control(run, prec) -> dict:
    """The gaps when the reference computed at `prec` stands in the
    program's place over the followed steps."""
    return gaps(follow(run, prec), follow(run, run.reference))


def _keep_state(step):
    """Adam's step computing nothing: parameters and moments unchanged."""
    from fenerf_tpu_torch.train import loop

    def unchanged(self, params, grads, state):
        return loop.AdamState(state.count + 1, state.mu, state.nu,
                              state.split)
    return unchanged


def _half_batch(d_loss):
    """The critics' loss on the first half of the batch, its means over
    those alone."""
    def half(d_params, dcfg, meta, real_in, fake_in, z_geo, z_app,
             positions, alpha):
        b = real_in.shape[0] // 2
        cut = lambda t: None if t is None else t[:b]
        return d_loss(d_params, dcfg, meta, real_in[:b], fake_in[:b],
                      cut(z_geo), cut(z_app), positions[:b], alpha)
    return half


def faults() -> dict:
    from fenerf_tpu_torch.train import ema, loop

    keep = faultlib.planted(loop.Optimizer, "step", _keep_state)
    no_ema = faultlib.planted(ema, "ema_update", lambda f: lambda st, p: st)

    @contextlib.contextmanager
    def state_unchanged():
        with keep(), no_ema():
            yield

    return {"state_unchanged": state_unchanged,
            "half_batch": faultlib.planted(loop, "_d_loss", _half_batch)}
