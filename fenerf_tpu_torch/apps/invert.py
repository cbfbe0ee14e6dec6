"""GAN inversion on the port (the editing entry point; counterpart of
fenerf_tpu/apps/invert.py): optimize W-space offsets against a
segmentation map (possibly hand-edited) + optional photo + perceptual loss.

Reference: inverse_render_double_semantic.py:
  * targets: 18ch one-hot seg in [-1,1] (mask2labels :81-91), normalized RGB;
    optional background masking (:276-304).
  * init: mean of 10k mapped samples + init_psi * (random sample - mean)
    per branch; zero offsets are the optimized variables (:307-350).
  * loss = lambda_seg*MSE(seg) + lambda_img*MSE(rgb) + lambda_percept*LPIPS
    + lambda_norm*mean(offsets^2)  (:387-404); rendered at image_size with
    hierarchical sampling OFF and annealed W noise 0.03*(N-i)/N (:381-385).
  * optimizer: Adam(1e-2, wd 1e-4) on the offset subset selected by the
    lambdas (seg-only -> geo branch, img-only -> app branch, both -> all);
    StepLR(100, gamma 0.75) (:371-377).
  * mIoU of the 256px hierarchical render vs the 19-class gt every 20 iters
    (:437-448); checkpoint = 8 film tensors (:453-464).

On the card a step's render runs through the fused forward and backward
field kernels (backend 'kernel_train'); only the offsets take gradients.
A step is a function of (offsets, optimizer state, draws): the W noise and
the render's jitter are drawn before it and passed in (step_draws), so a
test can replay it against the JAX package. Targets are PNG files
(utils/image.py::read_png); other formats raise.

Usage:
  python -m fenerf_tpu_torch.apps.invert NAME --ckpt out/generator.npz \
      --image_path face.png --seg_path face_seg.png --lambda_seg 1 \
      --lambda_img 1 [--load_offsets prior.npz] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from fenerf_tpu_torch.compat.jax_bridge import tree_leaves, tree_unflatten
from fenerf_tpu_torch.models import generator as gen
from fenerf_tpu_torch.train.loop import AdamState, Optimizer

BRANCHES = ("geo", "app")
# optax.chain(add_decayed_weights(1e-4), scale_by_adam(),
#             scale_by_learning_rate(exponential_decay(1e-2, 100, 0.75,
#                                                      staircase=True)))
# (fenerf_tpu/apps/invert.py:187-192): decay before Adam, no clip
OPTIMIZER = Optimizer(lr=1e-2, betas=(0.9, 0.999), max_norm=None,
                      weight_decay=1e-4, lr_decay=(100, 0.75))
NOISE = 0.03    # the W noise at step 0, annealed linearly to 0
EVAL_NUM_STEPS = 48   # coarse (and fine) samples per ray of the eval render


def one_hot_mask(mask_values, n_classes: int, skip_background: bool):
    """Reference mask2labels: 19-class keeps label i -> channel i; 18-class
    drops background (label i+1 -> channel i)."""
    m = np.asarray(mask_values).astype(np.int32)
    out = np.zeros((n_classes,) + m.shape, dtype=np.float32)
    for i in range(n_classes):
        out[i][m == (i + 1 if skip_background else i)] = 1.0
    return out


def miou(source_onehot, target_onehot) -> float:
    """Reference mIOU (:123-127): per-class intersection / support union."""
    s = np.asarray(source_onehot, dtype=np.float32)
    t = np.asarray(target_onehot, dtype=np.float32)
    inter = (s * t).sum(axis=(-2, -1))
    union = ((s + t) > 0).sum(axis=(-2, -1)).astype(np.float32)
    return float(np.mean(inter / (union + 1e-6)))


def load_targets(image_path, seg_path, image_size, background_mask,
                 white_background_mask=False, center_crop=True):
    """PNG photo + label map -> (gt_image (1,3,S,S) in [-1,1], gt18
    (1,18,S,S) in [-1,1], gt19 one-hot (1,19,256,256)), numpy. The same
    geometry and conversions as the JAX package's PIL path."""
    from fenerf_tpu_torch.data.celeba_mask import _prep
    from fenerf_tpu_torch.utils.image import read_png, resize, to_mode

    img = to_mode(read_png(image_path), "RGB")
    seg = to_mode(read_png(seg_path), "L")
    if seg.shape != img.shape[:2]:
        seg = resize(seg, (img.shape[1], img.shape[0]), "nearest")
    if background_mask or white_background_mask:
        i = img.astype(np.float32) / 255.0
        i[seg == 0] = 1.0 if white_background_mask else 0.0
        img = (i * 255).astype(np.uint8)

    def prep(a, size, nearest=False):
        if center_crop:
            # short side -> 320, center crop 256 (the dataset geometry,
            # reference transform_img, inverse_render...py:177-218)
            return _prep(a, size, nearest)
        return resize(a, (size, size), "nearest" if nearest else "bilinear")

    gt_img = prep(img, image_size).astype(np.float32) / 255.0
    gt_img = (gt_img.transpose(2, 0, 1)[None] - 0.5) / 0.5
    seg_small = prep(seg, image_size, nearest=True)
    gt18 = (one_hot_mask(seg_small, 18, True)[None] - 0.5) / 0.5
    seg_256 = prep(seg, 256, nearest=True)
    gt19 = one_hot_mask(seg_256, 19, False)[None]
    return gt_img, gt18, gt19


class Problem(NamedTuple):
    """What an inversion step holds fixed: the field, its render, the base
    W, the targets and the loss weights."""
    params: Any
    fcfg: Any
    rcfg: gen.RenderConfig
    w: dict                 # {"geo": (freq, phase), "app": (freq, phase)}
    gt_img: torch.Tensor    # (1, 3, S, S) in [-1, 1]
    gt18: torch.Tensor      # (1, 18, S, S) in [-1, 1]
    lambda_seg: float
    lambda_img: float
    lambda_percept: float
    lambda_norm: float
    percept: Callable | None
    mask: dict              # {"geo": 0. / 1., "app": 0. / 1.}


def noisy_film(w: dict, offsets: dict, noise: dict | None = None):
    """W + noise + offsets per branch -> (film_geo, film_app)."""
    def branch(br):
        parts = (w[br], offsets[br]) if noise is None else \
            (w[br], noise[br], offsets[br])
        return tuple(sum(xs[1:], xs[0]) for xs in zip(*parts))

    return branch("geo"), branch("app")


def step_draws(g: torch.Generator, prob: Problem, noise_scale: float,
               device):
    """The draws of one step: a normal per W leaf times noise_scale, and
    the render's draws (stratified jitter)."""
    noise = {br: tuple(torch.randn(x.shape, generator=g, device=device)
                       * noise_scale for x in prob.w[br])
             for br in BRANCHES}
    return noise, gen.draw_render(g, 1, prob.rcfg, 0.0, None, device)


def loss_fn(prob: Problem, offsets: dict, noise: dict,
            draws: gen.RenderDraws):
    """-> (loss, seg_loss, img_loss) of one step's render."""
    fg, fa = noisy_film(prob.w, offsets, noise)
    frame = gen.render(prob.params, prob.fcfg, prob.rcfg, fg, fa,
                       batch_size=1, noise_std=0.0, draws=draws)["pixels"]
    seg_loss = torch.mean((frame[:, :-3] - prob.gt18) ** 2)
    img_loss = torch.mean((frame[:, -3:] - prob.gt_img) ** 2)
    loss = prob.lambda_seg * seg_loss + prob.lambda_img * img_loss
    if prob.percept is not None:
        loss = loss + prob.lambda_percept * prob.percept(frame[:, -3:],
                                                         prob.gt_img)
    # the JAX dict's leaves in its tree order (app, then geo)
    norm_loss = sum(torch.mean(o ** 2) for br in sorted(offsets)
                    for o in offsets[br])
    loss = loss + prob.lambda_norm * norm_loss
    return loss, seg_loss, img_loss


def loss_and_grads(prob: Problem, offsets: dict, noise: dict,
                   draws: gen.RenderDraws):
    """-> ((loss, seg_loss, img_loss), gradients w.r.t. the offsets, in
    the offsets' structure; unmasked)."""
    req = {br: tuple(o.detach().requires_grad_(True) for o in offsets[br])
           for br in offsets}
    losses = loss_fn(prob, req, noise, draws)
    grads = torch.autograd.grad(losses[0], tree_leaves(req))
    return tuple(x.detach() for x in losses), tree_unflatten(req, list(grads))


def invert_step(prob: Problem, offsets: dict, opt_state: AdamState,
                noise: dict, draws: gen.RenderDraws):
    """One optimization step: the loss's gradient, masked to the optimized
    branches, then OPTIMIZER's update of `offsets` in place. Returns
    (optimizer state, (loss, seg_loss, img_loss))."""
    losses, grads = loss_and_grads(prob, offsets, noise, draws)
    grads = {br: tuple(g * prob.mask[br] for g in grads[br]) for br in grads}
    return OPTIMIZER.step(offsets, grads, opt_state), losses


def init_w(params, fcfg, init_seed: int, init_psi: float, device) -> dict:
    """The 10k-sample mean W, moved init_psi of the way toward one random
    draw; every draw from a generator seeded init_seed."""
    from fenerf_tpu_torch.nn import fields

    g = torch.Generator(device=device).manual_seed(init_seed)
    with torch.no_grad():
        avg_geo, avg_app = fields.avg_film(params, fcfg, g, n=10000)
        rand_geo, rand_app = fields.field_film(
            params, fcfg,
            torch.randn((1, fcfg.z_geo_dim), generator=g, device=device),
            torch.randn((1, fcfg.z_app_dim), generator=g, device=device))
    return {"geo": fields.truncate_film(rand_geo, avg_geo, init_psi),
            "app": fields.truncate_film(rand_app, avg_app, init_psi)}


class InversionResult(NamedTuple):
    path: str                 # the freq_phase_offset_{name}.npz
    losses: np.ndarray        # (iterations,) loss of every step
    mious: np.ndarray         # one per eval render
    ms_per_iteration: float   # a step, host clock, synchronized
    ms_per_eval: float        # an eval render + its mIoU


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("name")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--image_path", required=True)
    p.add_argument("--seg_path", required=True)
    p.add_argument("--save_dir", default="inversion")
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--iterations", type=int, default=1000)
    p.add_argument("--lambda_seg", type=float, default=0.0)
    p.add_argument("--lambda_img", type=float, default=0.0)
    p.add_argument("--lambda_percept", type=float, default=0.0)
    p.add_argument("--lambda_norm", type=float, default=1.0)
    p.add_argument("--init_psi", type=float, default=0.0)
    p.add_argument("--init_seed", type=int, default=0)
    p.add_argument("--background_mask", action="store_true")
    p.add_argument("--white_background_mask", action="store_true")
    p.add_argument("--lock_view_dependence", action="store_true")
    p.add_argument("--no_ema", dest="use_ema", action="store_false")
    p.add_argument("--eval_every", type=int, default=20)
    p.add_argument("--num_steps", type=int, default=24)
    p.add_argument("--load_offsets", default=None,
                   help="warm-start from a prior freq_phase_offset_*.npz: "
                        "its offsets fold into the W base and optimization "
                        "resumes from zero offsets (reference load_checkpoint"
                        ", inverse_render_double_semantic.py:352-361)")
    p.add_argument("--allow_no_lpips", action="store_true",
                   help="permit --lambda_percept > 0 without LPIPS weights "
                        "(the perceptual term is then dropped)")
    p.add_argument("--render_video", action="store_true",
                   help="not ported yet (needs a video writer)")
    p.add_argument("--device", default="cuda",
                   help="torch device (raises if CUDA is requested and "
                        "absent)")
    return p.parse_args(argv)


def main(argv=None) -> InversionResult:
    args = parse_args(argv)
    if args.render_video:
        raise NotImplementedError(
            "--render_video is not ported yet: the reconstruction video "
            "waits for the render_video slice (a video writer, ROADMAP A2)")

    from fenerf_tpu_torch.apps.common import best_backend, load_generator
    from fenerf_tpu_torch.nn import fields
    from fenerf_tpu_torch.ops import film_mlp

    dev = torch.device(args.device)
    params, ema, _, fcfg, _cfg = load_generator(args.ckpt, device=dev)
    if args.use_ema:
        params = ema
    os.makedirs(args.save_dir, exist_ok=True)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=dev)
    gt_img, gt18, gt19 = load_targets(
        args.image_path, args.seg_path, args.image_size,
        args.background_mask, args.white_background_mask)

    # ---- W init: 10k-sample mean +- init_psi toward one random draw ----
    w = init_w(params, fcfg, args.init_seed, args.init_psi, dev)
    if args.load_offsets:
        # warm start: prior W + prior offsets become the new base
        # (reference folds meta offsets into w, inverse_render...py:352-361);
        # the freq_*/phase_* entries already carry w + offsets
        with np.load(args.load_offsets) as prior:
            w = {br: (t(prior[f"freq_{br}"]), t(prior[f"phase_{br}"]))
                 for br in BRANCHES}
        print(f"warm start from {args.load_offsets}")
    offsets = {br: tuple(torch.zeros_like(x) for x in w[br])
               for br in BRANCHES}

    # offset subset: seg-only optimizes geo, img-only optimizes app
    opt_geo = args.lambda_img == 0 or (args.lambda_seg > 0)
    opt_app = args.lambda_seg == 0 or (args.lambda_img > 0)

    rcfg = gen.RenderConfig(
        img_size=args.image_size, num_steps=args.num_steps,
        hierarchical=False, h_stddev=0.0, v_stddev=0.0, sample_dist=None,
        lock_view_dependence=args.lock_view_dependence,
        backend=best_backend(fcfg, dev, train=True))
    eval_rcfg = gen.RenderConfig(
        img_size=256, num_steps=EVAL_NUM_STEPS, hierarchical=True,
        h_stddev=0.0, v_stddev=0.0, sample_dist=None,
        lock_view_dependence=args.lock_view_dependence,
        fill_mode="eval_seg_padding_background", ray_chunk=8192,
        backend=best_backend(fcfg, dev))
    print(f"[invert] step backend {rcfg.backend}, eval backend "
          f"{eval_rcfg.backend}, eval ray route "
          f"{gen.ray_route(eval_rcfg, dev)[0]}")

    percept = None
    if args.lambda_percept > 0:
        from fenerf_tpu_torch.eval.lpips import load_lpips

        percept = load_lpips(device=dev)
        if percept is None:
            # silently optimizing a DIFFERENT objective than requested is
            # worse than failing; --allow_no_lpips is the explicit opt-out
            msg = ("--lambda_percept > 0 but no LPIPS weights are available "
                   "($FENERF_LPIPS_WEIGHTS; see fenerf_tpu_torch/eval/"
                   "lpips.py)")
            if not args.allow_no_lpips:
                raise SystemExit(msg + " — pass --allow_no_lpips to proceed "
                                       "without the perceptual term")
            print(f"WARNING: {msg}; term dropped (--allow_no_lpips)")

    # the texture table once (the parameters take no gradient here): bf16
    # for the kernels, f32 for the torch route in f32
    table = lambda r: None if r.backend == "torch" else torch.bfloat16
    step_params = fields.with_grid_table(params, fcfg, table(rcfg))
    eval_params = fields.with_grid_table(params, fcfg, table(eval_rcfg))
    if eval_rcfg.backend == "kernel":
        eval_params = film_mlp.with_pack(eval_params, fcfg)
    prob = Problem(step_params, fcfg, rcfg, w, t(gt_img), t(gt18),
                   args.lambda_seg, args.lambda_img, args.lambda_percept,
                   args.lambda_norm, percept,
                   {"geo": float(opt_geo), "app": float(opt_app)})
    opt_state = OPTIMIZER.init(offsets)

    @torch.no_grad()
    def eval_render():
        fg, fa = noisy_film(w, offsets)
        return gen.render(
            eval_params, fcfg, eval_rcfg, fg, fa, batch_size=1,
            noise_std=0.0,
            generator=torch.Generator(device=dev).manual_seed(0))["pixels"]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    g = torch.Generator(device=dev).manual_seed(args.init_seed + 1)
    mious, losses = [], []
    t_steps = t_evals = 0.0
    sync()
    mark = time.perf_counter()
    for i in range(args.iterations):
        noise_scale = NOISE * (args.iterations - i) / args.iterations
        noise, draws = step_draws(g, prob, noise_scale, dev)
        opt_state, (loss, seg_l, img_l) = invert_step(
            prob, offsets, opt_state, noise, draws)
        losses.append(loss)
        if i % args.eval_every == 0:
            sync()
            now = time.perf_counter()
            t_steps += now - mark
            pix = eval_render().float().cpu().numpy()
            gen_mask = np.argmax(pix[:, :-3], axis=1)[0]
            gen19 = one_hot_mask(gen_mask, 19, False)[None]
            m = miou(gen19, gt19)
            mious.append(m)
            mark = time.perf_counter()
            t_evals += mark - now
            print(f"iter {i}: loss={float(loss):.4f} seg={float(seg_l):.4f} "
                  f"img={float(img_l):.4f} mIoU={m:.4f}")
    sync()
    t_steps += time.perf_counter() - mark

    out_path = os.path.join(args.save_dir,
                            f"freq_phase_offset_{args.name}.npz")
    host = lambda x: x.detach().cpu().numpy()
    arrays = {}
    for br in BRANCHES:
        for k, name in enumerate(("freq", "phase")):
            arrays[f"{name}_{br}"] = host(w[br][k] + offsets[br][k])
            arrays[f"w_{name}_{br}"] = host(w[br][k])
            arrays[f"offset_{name}_{br}"] = host(offsets[br][k])
    np.savez(out_path, **arrays)
    np.save(os.path.join(args.save_dir, "mious.npy"), np.asarray(mious))
    try:  # mIoU-vs-iteration figure (reference tools.py:636 plot_miou)
        from fenerf_tpu_torch.utils.plots import plot_miou

        plot_miou(args.save_dir, log_every=20)
    except ImportError:
        pass  # matplotlib absent: the .npy still carries the trace
    print(f"saved {out_path}")
    losses = (torch.stack(losses).cpu().numpy() if losses
              else np.zeros(0, np.float32))
    return InversionResult(
        out_path, losses, np.asarray(mious),
        t_steps / max(args.iterations, 1) * 1e3,
        t_evals / max(len(mious), 1) * 1e3)


if __name__ == "__main__":
    main()
