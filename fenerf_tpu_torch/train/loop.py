"""The GAN training step: D_img -> D_seg -> G, with R1, topk and two EMAs
(port of fenerf_tpu/train/loop.py, both model families).

One call is one optimizer step of each of the three networks:

  * D_img: fresh fakes (no G gradients, the forward kernel on the card),
    R1 on the reals by double backprop, the pose penalty on the fakes,
    the softplus GAN loss, global-norm clip, Adam.
  * D_seg: the same with reals [18 label channels | 3 rgb] and the full
    generator output as fakes.
  * G: either batch_split microbatches with gradients accumulated in f32,
    or one full-batch pass that computes the same split objective
    (meta.full_batch). D_seg sees [labels | rgb.detach()]; topk keeps the
    ceil(frac * chunk) best fakes of each chunk; then one Adam step and
    both EMA updates. On the card G's renders run through the fused
    forward and backward kernels (backend 'kernel_train').
  * The latent-grid family (GridFieldConfig) is RGB-only, so it has no
    D_seg phase; its field has no kernel, so every render of its step
    takes the torch route (film_mlp.backend_for), as the JAX trainer's
    take XLA's, the ray machinery included.
  * With a DiffAugment policy (meta.diff_augment_policy) D_img's reals
    and fakes take one augmentation and each G microbatch's fakes one of
    their own before the image critic, never the seg critic's inputs;
    with meta.grad_rays < 1 G's render differentiates a random
    chunk-aligned subset of its rays (models/generator.py).

The texture table is built once per step and shared by every render of
the step; in the G phase it is a leaf of its own, whose cotangent is
accumulated in f32 over the microbatches and folded into the grid's
gradient once by the hand adjoint (zexp_table_adjoint).

Every random number of a step can be passed in as `draws` (StepDraws);
without it they come from a torch.Generator. Parameters and optimizer
moments are updated in place (the step returns the same tensors).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from fenerf_tpu_torch.compat.jax_bridge import (tree_leaves, tree_map,
                                               tree_unflatten)
from fenerf_tpu_torch.core.grid_sample import (build_zexp_table,
                                               zexp_table_adjoint)
from fenerf_tpu_torch.models import generator as gen
from fenerf_tpu_torch.nn import discriminators as disc
from fenerf_tpu_torch.nn import fields
from fenerf_tpu_torch.ops import film_mlp
from fenerf_tpu_torch.train import ema as emalib
from fenerf_tpu_torch.train.diff_augment import (diff_augment,
                                                 make_augment_draws)
from fenerf_tpu_torch.train.curriculum import StageMeta

Params = Any


class StepScalars(NamedTuple):
    """Per-step inputs (everything else is fixed per stage): floats or
    0-dim tensors."""
    alpha: Any       # fade-in in [0, 1]
    noise_std: Any   # annealed sigma noise
    topk_frac: Any   # fraction of fakes kept in the G loss


class AdamState(NamedTuple):
    count: int
    mu: Params
    nu: Params
    # top-level keys with a scaled learning rate (Optimizer.lr_mult): the
    # JAX package keeps them in an optax partition of their own, which
    # its checkpoint layout follows (utils/checkpoint.py)
    split: tuple = ()


class TrainState(NamedTuple):
    g_params: Params
    d_img_params: Params
    d_seg_params: Params
    opt_g: AdamState
    opt_img: AdamState
    opt_seg: AdamState
    ema: emalib.EmaState
    ema2: emalib.EmaState
    step: int


class StepDraws(NamedTuple):
    """Every random number of one step: each phase's latents (z_geo, z_app)
    and the RenderDraws of each of its renders (one per microbatch; G's
    carry the ray permutation when grad_rays < 1), and with a DiffAugment
    policy the draws of D_img's augmentation (reals and fakes alike) and
    of each G microbatch's (train/diff_augment.py)."""
    z_img: tuple
    fakes_img: list
    z_seg: tuple | None
    fakes_seg: list | None
    z_g: tuple
    g_renders: list
    aug_d: list | None = None
    aug_g: list | None = None


# ---------------------------------------------------------------------------
# Optimizers: optax.chain(clip_by_global_norm, [add_decayed_weights], adam)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Adam (eps 1e-8) after a global-norm clip written as optax's (scale
    by max_norm / norm only when norm >= max_norm; max_norm None: no clip)
    and, when set, weight decay added to the clipped gradient. `lr_mult`
    scales the learning rate of top-level parameter groups (the mapping
    networks). `lr_decay` = (transition_steps, rate) is optax's staircase
    exponential_decay: update i (counted from 0) takes
    lr * rate ** (i // transition_steps)."""
    lr: float
    betas: tuple
    max_norm: float | None
    weight_decay: float = 0.0
    lr_mult: tuple = ()          # ((top-level key, multiplier), ...)
    lr_decay: tuple = ()         # (transition_steps, rate), or () for none

    def lr_at(self, count: int) -> float:
        """The learning rate of the update made at `count` (the count
        before the increment); a decayed one in f32, as optax's schedule
        computes it."""
        if not self.lr_decay:
            return self.lr
        f32 = np.float32
        steps, rate = self.lr_decay
        return float(f32(self.lr) * f32(rate) ** f32(count // steps))

    def init(self, params: Params) -> AdamState:
        zeros = lambda t: torch.zeros_like(t, dtype=torch.float32)
        mult = dict(self.lr_mult)
        return AdamState(0, tree_map(zeros, params), tree_map(zeros, params),
                         tuple(sorted(k for k in params if k in mult)))

    @torch.no_grad()
    def step(self, params: Params, grads: Params,
             state: AdamState) -> AdamState:
        """Update `params` and the moments in place; returns the state."""
        clip = False
        if self.max_norm is not None:
            gl = tree_leaves(grads)
            norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in gl))
            clip = bool(norm >= self.max_norm)
        base = self.lr_at(state.count)
        count = state.count + 1
        f32 = np.float32
        b1, b2 = self.betas
        c1 = float(f32(1.0) - f32(b1) ** count)
        c2 = float(f32(1.0) - f32(b2) ** count)
        mult = dict(self.lr_mult)
        groups = {k: base * mult.get(k, 1.0) for k in params}
        for key in params:
            lr = float(f32(groups[key]))
            for p, g, m, v in zip(tree_leaves(params[key]),
                                  tree_leaves(grads[key]),
                                  tree_leaves(state.mu[key]),
                                  tree_leaves(state.nu[key])):
                g = g.float()
                if clip:
                    g = g / norm * self.max_norm
                if self.weight_decay:
                    g = g + self.weight_decay * p
                m.mul_(b1).add_((1.0 - b1) * g)
                v.mul_(b2).add_((1.0 - b2) * (g * g))
                upd = (m / c1) / (torch.sqrt(v / c2) + 1e-8)
                p.add_(-lr * upd)
        return AdamState(count, state.mu, state.nu, state.split)


_MAP_KEYS = ("geo_map", "app_map", "map")


def make_g_optimizer(meta: StageMeta) -> Optimizer:
    mult = (tuple((k, meta.mapping_lr_mult) for k in _MAP_KEYS)
            if meta.unique_lr else ())
    return Optimizer(meta.gen_lr, tuple(meta.betas), meta.grad_clip,
                     meta.weight_decay, mult)


def make_d_optimizer(meta: StageMeta, which: str) -> Optimizer:
    lr = meta.disc_img_lr if which == "img" else meta.disc_seg_lr
    return Optimizer(lr, tuple(meta.betas), meta.grad_clip, meta.weight_decay)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to "
                           "train on the CPU")
    return dev


def init_train_state(meta: StageMeta, seed: int = 0,
                     device="cuda") -> TrainState:
    """Random G (either family), D_img and D_seg from `seed`, fresh
    optimizers and EMAs."""
    dev = _device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    return train_state_from_params(
        meta, gen.init_any_field(g, meta.field_config(), device=dev),
        disc.init_discriminator(g, meta.disc_img_config(), device=dev),
        disc.init_discriminator(g, meta.disc_seg_config(), device=dev))


def train_state_from_params(meta: StageMeta, g_params: Params,
                            d_img: Params, d_seg: Params) -> TrainState:
    """A step-0 state around given networks (e.g. carried over from the
    JAX package by compat/jax_bridge.py): fresh optimizers and EMAs."""
    return TrainState(
        g_params=g_params, d_img_params=d_img, d_seg_params=d_seg,
        opt_g=make_g_optimizer(meta).init(g_params),
        opt_img=make_d_optimizer(meta, "img").init(d_img),
        opt_seg=make_d_optimizer(meta, "seg").init(d_seg),
        ema=emalib.ema_init(g_params, 0.999),
        ema2=emalib.ema_init(g_params, 0.9999), step=0)


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------

def make_step_draws(generator: torch.Generator, meta: StageMeta, batch: int,
                    noise_std, device) -> StepDraws:
    """All random numbers of one step from `generator` on `device`."""
    rcfg = meta.render_config()
    s = meta.batch_split

    def z():
        shapes = ((batch, meta.latent_geo_dim), (batch, meta.latent_app_dim))
        if meta.z_dist == "uniform":
            return tuple(torch.rand(sh, generator=generator, device=device)
                         * 2 - 1 for sh in shapes)
        return tuple(torch.randn(sh, generator=generator, device=device)
                     for sh in shapes)

    def renders(n, cfg=rcfg):
        return [gen.draw_render(generator, batch // n, cfg, noise_std,
                                cfg.sample_dist, device) for _ in range(n)]

    n = 1 if meta.full_batch else s
    z_img, f_img = z(), renders(n)
    has_seg = meta.output_dim > 4
    z_seg = z() if has_seg else None
    f_seg = renders(n) if has_seg else None
    z_g = z()
    g_renders = renders(n, dataclasses.replace(rcfg,
                                               grad_rays=meta.grad_rays))
    aug_d = aug_g = None
    policy = meta.diff_augment_policy
    if policy:
        size = (meta.img_size, meta.img_size)
        aug_d = make_augment_draws(generator, policy, batch, size, device)
        aug_g = [make_augment_draws(generator, policy, batch // n, size,
                                    device) for _ in range(n)]
    return StepDraws(z_img, f_img, z_seg, f_seg, z_g, g_renders, aug_d,
                     aug_g)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _mse(a, b):
    return torch.mean((a - b) ** 2)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _render_fakes(render_params, fcfg, rcfg, z_geo, z_app, draws, noise_std):
    """The fakes of a D phase, one render per microbatch of the split,
    without gradients; on the card through the forward kernel."""
    rcfg = dataclasses.replace(
        rcfg, backend=film_mlp.backend_for(fcfg, z_geo.device))
    s = len(draws)
    b = z_geo.shape[0]
    pix, pos, op = [], [], []
    with torch.no_grad():
        for i in range(s):
            sl = slice(i * b // s, (i + 1) * b // s)
            out = gen.render_any(render_params, fcfg, rcfg, z_geo[sl],
                                 z_app[sl], noise_std, draws=draws[i])
            pix.append(out["pixels"])
            pos.append(out["position"])
            op.append(out["opacity"].mean())
    return torch.cat(pix), torch.cat(pos), torch.stack(op).mean()


def _identity(meta, geo, app, pos, z_geo, z_app, positions):
    t = 0.0
    if meta.z_geo_lambda:
        t = t + meta.z_geo_lambda * _mse(geo, z_geo)
    if meta.z_app_lambda:
        t = t + meta.z_app_lambda * _mse(app, z_app)
    if meta.pos_lambda:
        t = t + meta.pos_lambda * _mse(pos, positions)
    return t


def _d_loss(d_params, dcfg, meta: StageMeta, real_in, fake_in, z_geo, z_app,
            positions, alpha):
    """Discriminator loss with R1 (double backprop through the critic) and
    the identity / pose penalties."""
    if meta.r1_lambda:
        real = real_in.detach().requires_grad_(True)
        r_scores = disc.apply_discriminator(d_params, dcfg, real, alpha)[0]
        (r1_grad,) = torch.autograd.grad(r_scores.sum(), real,
                                         create_graph=True)
        b = real.shape[0]
        r1 = 0.5 * meta.r1_lambda * (r1_grad.reshape(b, -1) ** 2).sum(
            -1).mean()
    else:
        r_scores = disc.apply_discriminator(d_params, dcfg, real_in,
                                            alpha)[0]
        r1 = 0.0
    f_score, f_geo, f_app, f_pos = disc.apply_discriminator(
        d_params, dcfg, fake_in, alpha)
    return (_softplus(f_score).mean() + _softplus(-r_scores).mean() + r1
            + _identity(meta, f_geo, f_app, f_pos, z_geo, z_app, positions))


def _chunk_topk_softplus(scores, frac, n_chunks: int):
    """Sum over n_chunks chunks of softplus(-score) averaged over the
    ceil(frac * chunk) best-scored fakes of each chunk; k from an f32
    product, as the JAX package computes it."""
    rows = torch.sort(scores.reshape(n_chunks, -1), dim=1,
                      descending=True).values
    sp = _softplus(-rows)
    bs = rows.shape[1]
    frac32 = torch.as_tensor(frac, dtype=torch.float32, device=rows.device)
    k = torch.ceil(frac32 * bs).to(torch.int32)
    mask = (torch.arange(bs, device=rows.device) < k).to(sp.dtype)
    return torch.sum(sp * mask) / k


def _g_loss(g_params, d_img_params, d_seg_params, fcfg, rcfg,
            meta: StageMeta, z_geo, z_app, scal: StepScalars, n_chunks: int,
            draws, aug_draws=None):
    out = gen.render_any(g_params, fcfg, rcfg, z_geo, z_app, scal.noise_std,
                         draws=draws)
    pixels, positions = out["pixels"], out["position"]
    fake_rgb = pixels[:, -3:]
    d_img_in = fake_rgb
    if meta.diff_augment_policy:
        d_img_in = diff_augment(fake_rgb, meta.diff_augment_policy,
                                aug_draws)
    img_s, img_geo, img_app, img_pos = disc.apply_discriminator(
        d_img_params, meta.disc_img_config(), d_img_in, scal.alpha)
    # the identity term is a per-sample mean: summed over an equal-size
    # partition it is n_chunks times the full-batch mean
    g_img = (_chunk_topk_softplus(img_s[:, 0], scal.topk_frac, n_chunks)
             + n_chunks * _identity(meta, img_geo, img_app, img_pos, z_geo,
                                    z_app, positions))
    g_seg = torch.zeros((), device=pixels.device)
    if meta.output_dim > 4:
        seg_in = torch.cat([pixels[:, :-3], fake_rgb.detach()], dim=1)
        seg_s, seg_geo, seg_app, seg_pos = disc.apply_discriminator(
            d_seg_params, meta.disc_seg_config(), seg_in, scal.alpha)
        g_seg = (_chunk_topk_softplus(seg_s[:, 0], scal.topk_frac, n_chunks)
                 + n_chunks * _identity(meta, seg_geo, seg_app, seg_pos,
                                        z_geo, z_app, positions)
                 ) * meta.g_seg_loss_lambda
    return g_img + g_seg, (g_img, g_seg)


def _grads(loss, params: Params) -> Params:
    """d loss / d params as a tree of f32 tensors (zeros where unused)."""
    leaves = tree_leaves(params)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return tree_unflatten(params, [
        torch.zeros_like(t, dtype=torch.float32) if g is None else g.float()
        for t, g in zip(leaves, gs)])


def _leaf_copy(params: Params) -> Params:
    """Fresh leaves sharing storage, to differentiate against."""
    return tree_map(lambda t: t.detach().requires_grad_(True), params)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def train_step(state: TrainState, real_imgs: torch.Tensor,
               real_labels: torch.Tensor, scal: StepScalars,
               meta: StageMeta, draws: StepDraws | None = None,
               generator: torch.Generator | None = None):
    """One step of D_img, D_seg and G. real_imgs (B, 3, H, W) and
    real_labels (B, 18, H, W) in [-1, 1] (not read when the model is
    RGB-only). Returns (state, metrics)."""
    fcfg = meta.field_config()
    rcfg = meta.render_config()
    dev = real_imgs.device
    b = real_imgs.shape[0]
    s = meta.batch_split
    if b % s:
        raise ValueError(f"batch {b} not divisible by batch_split {s}")
    has_seg = meta.output_dim > 4
    if draws is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(state.step)
        draws = make_step_draws(generator, meta, b, scal.noise_std, dev)

    g_bk = film_mlp.backend_for(fcfg, dev, train=True)
    # grad_rays < 1: G's render differentiates a subset of its rays (the
    # D-phase fakes have no gradients anyway)
    g_rcfg = dataclasses.replace(rcfg, backend=g_bk,
                                 remat=rcfg.remat and g_bk == "torch",
                                 grad_rays=meta.grad_rays)
    policy = meta.diff_augment_policy
    if policy and (draws.aug_d is None or draws.aug_g is None):
        raise ValueError(f"diff_augment_policy {policy!r} needs the "
                         f"augmentation draws in StepDraws")
    # the image critic's inputs only, reals and fakes with the same draws
    # (the seg critic needs pixel-aligned masks)
    aug = ((lambda x: diff_augment(x, policy, draws.aug_d)) if policy
           else (lambda x: x))
    if g_bk == "torch" and rcfg.compute_dtype == "float32":
        table_dtype = None
    else:
        table_dtype = torch.bfloat16
    # the film family's texture table (the grid family has none)
    use_table = isinstance(fcfg, fields.FieldConfig) and bool(
        fcfg.grid_channels)
    with torch.no_grad():
        render_params = state.g_params
        if use_table:
            render_params = {**render_params, fields.GRID_TABLE_KEY:
                             build_zexp_table(state.g_params["grid"],
                                              table_dtype)}
    metrics = {}

    # ---------------- D_img ----------------
    zg, za = draws.z_img
    fake_pix, fake_pos, metrics["fake_opacity"] = _render_fakes(
        render_params, fcfg, rcfg, zg, za, draws.fakes_img, scal.noise_std)
    d = _leaf_copy(state.d_img_params)
    loss = _d_loss(d, meta.disc_img_config(), meta, aug(real_imgs),
                   aug(fake_pix[:, -3:]), zg, za, fake_pos, scal.alpha)
    opt_img = make_d_optimizer(meta, "img").step(
        state.d_img_params, _grads(loss, d), state.opt_img)
    metrics["d_img_loss"] = loss.detach()

    # ---------------- D_seg ----------------
    opt_seg = state.opt_seg
    metrics["d_seg_loss"] = torch.zeros((), device=dev)
    if has_seg:
        zg, za = draws.z_seg
        fake_pix, fake_pos, _ = _render_fakes(
            render_params, fcfg, rcfg, zg, za, draws.fakes_seg,
            scal.noise_std)
        d = _leaf_copy(state.d_seg_params)
        loss = _d_loss(d, meta.disc_seg_config(), meta,
                       torch.cat([real_labels, real_imgs], dim=1), fake_pix,
                       zg, za, fake_pos, scal.alpha)
        opt_seg = make_d_optimizer(meta, "seg").step(
            state.d_seg_params, _grads(loss, d), state.opt_seg)
        metrics["d_seg_loss"] = loss.detach()

    # ---------------- G ----------------
    zg, za = draws.z_g
    n = len(draws.g_renders)
    bs = b // n
    g_grads = None
    g_loss = g_img = g_seg = 0.0
    for i in range(n):
        rp = _leaf_copy(render_params)
        sl = slice(i * bs, (i + 1) * bs)
        loss, (li, ls) = _g_loss(
            rp, state.d_img_params, state.d_seg_params, fcfg, g_rcfg, meta,
            zg[sl], za[sl], scal, s if n == 1 else 1, draws.g_renders[i],
            draws.aug_g[i] if policy else None)
        grads = _grads(loss, rp)
        # f32 accumulation over microbatches (the table's cotangent too)
        g_grads = grads if g_grads is None else tree_unflatten(grads, [
            a + c for a, c in zip(tree_leaves(g_grads), tree_leaves(grads))])
        g_loss, g_img, g_seg = (g_loss + loss.detach(), g_img + li.detach(),
                                g_seg + ls.detach())
    if use_table:
        dtable = g_grads.pop(fields.GRID_TABLE_KEY)
        g_grads["grid"] = g_grads["grid"] + zexp_table_adjoint(
            dtable, tuple(state.g_params["grid"].shape))
    opt_g = make_g_optimizer(meta).step(state.g_params, g_grads, state.opt_g)
    metrics.update(g_loss=g_loss, g_img_loss=g_img, g_seg_loss=g_seg)
    metrics["d_loss"] = metrics["d_img_loss"] + metrics["d_seg_loss"]
    new_state = TrainState(
        g_params=state.g_params, d_img_params=state.d_img_params,
        d_seg_params=state.d_seg_params, opt_g=opt_g, opt_img=opt_img,
        opt_seg=opt_seg, ema=emalib.ema_update(state.ema, state.g_params),
        ema2=emalib.ema_update(state.ema2, state.g_params),
        step=state.step + 1)
    return new_state, metrics
