"""Plain FENeRF training step (train_double_latent_semantic.py as published),
in float32: D_img, then D_seg, then G, then both EMAs.

  D phase   fakes rendered without gradients, one render per microbatch;
            softplus GAN loss on fakes and reals, R1 on the reals (the
            squared norm of the score's input gradient, by double
            backprop), the pose penalty on the fakes; the gradient's global
            norm clipped, then Adam.
  G phase   per microbatch: a differentiable render; D_img on its RGB and
            D_seg on [labels | RGB held constant], each loss the mean of
            softplus(-score) over the ceil(frac * n) best-scored fakes plus
            the pose penalty, D_seg's times g_seg_lambda; gradients summed
            over the microbatches, clipped, Adam (the mapping networks at a
            scaled learning rate).
  EMA       e <- e - (1 - min(decay, (1 + n) / (10 + n))) (e - p), at 0.999
            and 0.9999.

Adam is optax's: beta1 0, beta2 0.9, eps 1e-8 outside the square root, bias
corrections 1 - beta^t. `step` returns the losses and each network's
gradient as Adam received it (after the clip).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import critics, film_field
from benchmark.reference import render as ref_render
from benchmark.reference.precision import Products


class Hyper(NamedTuple):
    batch: int
    split: int
    spec: ref_render.RenderSpec
    gen_lr: float
    disc_img_lr: float
    disc_seg_lr: float
    betas: tuple = (0.0, 0.9)
    grad_clip: float = 10.0
    r1_lambda: float = 0.2
    pos_lambda: float = 15.0
    g_seg_lambda: float = 0.1
    mapping_lr_mult: float = 0.05
    ray_chunk: int = 2048


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


class Adam:
    """One network's optimizer state."""

    def __init__(self, params, lr: float, hp: Hyper, mult: dict | None = None):
        self.lr, self.hp, self.mult = lr, hp, mult or {}
        self.m = tree_map(torch.zeros_like, params)
        self.v = tree_map(torch.zeros_like, params)
        self.count = 0

    @torch.no_grad()
    def step(self, params, grads):
        """Clip the gradients' global norm, update params in place; returns
        the gradients as clipped."""
        gl = leaves(grads)
        norm = torch.sqrt(sum((g * g).sum() for g in gl))
        if norm >= self.hp.grad_clip:
            grads = tree_map(lambda g: g / norm * self.hp.grad_clip, grads)
        self.count += 1
        b1, b2 = self.hp.betas
        f32 = np.float32
        c1 = float(f32(1.0) - f32(b1) ** self.count)
        c2 = float(f32(1.0) - f32(b2) ** self.count)
        for key in params:
            lr = float(f32(self.lr * self.mult.get(key, 1.0)))
            for p, g, m, v in zip(leaves(params[key]), leaves(grads[key]),
                                  leaves(self.m[key]), leaves(self.v[key])):
                m.mul_(b1).add_((1.0 - b1) * g)
                v.mul_(b2).add_((1.0 - b2) * g * g)
                p.add_(-lr * (m / c1) / (torch.sqrt(v / c2) + 1e-8))
        return grads


class Ema:
    def __init__(self, params, decay: float):
        self.params = tree_map(lambda t: t.detach().clone(), params)
        self.decay, self.n = decay, 0

    @torch.no_grad()
    def update(self, params):
        self.n += 1
        f32 = np.float32
        d = min(f32(self.decay), (f32(1.0) + f32(self.n))
                / (f32(10.0) + f32(self.n)))
        one_minus = float(f32(1.0) - d)
        for e, p in zip(leaves(self.params), leaves(params)):
            e.sub_(one_minus * (e - p))


class State:
    """The networks, their optimizers and the EMAs."""

    def __init__(self, g, d_img, d_seg, hp: Hyper):
        self.g, self.d_img, self.d_seg = g, d_img, d_seg
        maps = {"geo_map": hp.mapping_lr_mult, "app_map": hp.mapping_lr_mult}
        self.opt_g = Adam(g, hp.gen_lr, hp, maps)
        self.opt_img = Adam(d_img, hp.disc_img_lr, hp)
        self.opt_seg = Adam(d_seg, hp.disc_seg_lr, hp)
        self.ema = Ema(g, 0.999)
        self.ema2 = Ema(g, 0.9999)


def _softplus(x):
    return F.softplus(x)


def _grads(loss, params):
    ls = leaves(params)
    gs = torch.autograd.grad(loss, ls, allow_unused=True)
    it = iter([torch.zeros_like(t) if g is None else g
               for t, g in zip(ls, gs)])
    return tree_map(lambda _: next(it), params)


def _render(g, zg, za, draws, hp: Hyper, prec: Products, grad: bool,
            record=None):
    films = film_field.film(g, zg, za, prec)
    field = lambda p, d: film_field.field(g, p, d, *films, prec=prec)
    out = ref_render.render(field, hp.spec, draws, zg.shape[0],
                            ray_chunk=hp.ray_chunk, checkpoint=grad,
                            device=zg.device)
    if record is not None:
        record.append(out["pixels"].detach().cpu())
    return out


def _fakes(g, z, draws, hp, prec, record=None):
    zg, za = z
    s, n = len(draws), zg.shape[0] // len(draws)
    pix, pos = [], []
    with torch.no_grad():
        for i in range(s):
            out = _render(g, zg[i * n:(i + 1) * n], za[i * n:(i + 1) * n],
                          draws[i], hp, prec, grad=False, record=record)
            pix.append(out["pixels"])
            pos.append(out["position"])
    return torch.cat(pix), torch.cat(pos)


def _d_phase(d, reals, fakes, positions, alpha, hp, prec):
    p = tree_map(lambda t: t.detach().requires_grad_(True), d)
    real = reals.detach().requires_grad_(True)
    r_score = critics.critic(p, real, alpha, prec.critics)[0]
    (rg,) = torch.autograd.grad(r_score.sum(), real, create_graph=True)
    r1 = 0.5 * hp.r1_lambda * (rg.reshape(rg.shape[0], -1) ** 2).sum(
        -1).mean()
    f_score, _, _, f_pos = critics.critic(p, fakes, alpha, prec.critics)
    loss = (_softplus(f_score).mean() + _softplus(-r_score).mean() + r1
            + hp.pos_lambda * ((f_pos - positions) ** 2).mean())
    return loss, _grads(loss, p)


def _topk_softplus(scores, frac):
    n = scores.shape[0]
    k = int(math.ceil(float(np.float32(frac) * np.float32(n))))
    kept = torch.topk(scores[:, 0], k).values
    return _softplus(-kept).sum() / k


def _g_phase(state: State, z, draws, alpha, frac, hp, prec, record=None):
    zg_all, za_all = z
    s, n = len(draws), zg_all.shape[0] // len(draws)
    total, acc = 0.0, None
    for i in range(s):
        p = tree_map(lambda t: t.detach().requires_grad_(True), state.g)
        zg, za = zg_all[i * n:(i + 1) * n], za_all[i * n:(i + 1) * n]
        out = _render(p, zg, za, draws[i], hp, prec, grad=True,
                      record=record)
        pix, pos = out["pixels"], out["position"]
        rgb = pix[:, -3:]
        s_img, _, _, p_img = critics.critic(state.d_img, rgb, alpha,
                                            prec.critics)
        s_seg, _, _, p_seg = critics.critic(
            state.d_seg, torch.cat([pix[:, :-3], rgb.detach()], 1), alpha,
            prec.critics)
        loss = (_topk_softplus(s_img, frac)
                + hp.pos_lambda * ((p_img - pos) ** 2).mean()
                + hp.g_seg_lambda * (_topk_softplus(s_seg, frac)
                                     + hp.pos_lambda
                                     * ((p_seg - pos) ** 2).mean()))
        gl = leaves(_grads(loss, p))
        acc = gl if acc is None else [a + b for a, b in zip(acc, gl)]
        total = total + float(loss.detach())
    it = iter(acc)
    grads = tree_map(lambda _: next(it), state.g)
    return total, grads


def step(state: State, reals, labels, draws: dict, alpha, frac,
         hp: Hyper, prec: Products, record=None) -> tuple[dict, dict]:
    """One training step on `state` (updated in place). draws: z_img,
    fakes_img, z_seg, fakes_seg, z_g, g_renders (latent pairs and per-
    microbatch render Draws). Returns (losses, clipped gradients); with a
    list `record`, every render's pixels are appended to it in order."""
    fake, pos = _fakes(state.g, draws["z_img"], draws["fakes_img"], hp, prec,
                       record)
    loss_img, g_img = _d_phase(state.d_img, reals, fake[:, -3:], pos, alpha,
                               hp, prec)
    g_img = state.opt_img.step(state.d_img, g_img)
    fake, pos = _fakes(state.g, draws["z_seg"], draws["fakes_seg"], hp, prec,
                       record)
    loss_seg, g_seg = _d_phase(state.d_seg, torch.cat([labels, reals], 1),
                               fake, pos, alpha, hp, prec)
    g_seg = state.opt_seg.step(state.d_seg, g_seg)
    loss_g, g_g = _g_phase(state, draws["z_g"], draws["g_renders"], alpha,
                           frac, hp, prec, record)
    g_g = state.opt_g.step(state.g, g_g)
    state.ema.update(state.g)
    state.ema2.update(state.g)
    losses = {"d_img_loss": float(loss_img.detach()),
              "d_seg_loss": float(loss_seg.detach()),
              "g_loss": loss_g}
    return losses, {"g": g_g, "d_img": g_img, "d_seg": g_seg}
