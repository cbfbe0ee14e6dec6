"""Adversarial training CLI on the port (counterpart of
fenerf_tpu/apps/train.py, on one device).

Reference: train_double_latent_semantic.py. The loop is the JAX
package's: curriculum stages with their data loader and kernel route, the
fixed sample grids, `options.txt`, `metrics.jsonl` (with images/s and the
peak device memory), the divergence watchdog, periodic `train_state.npz`
and `generator.npz` checkpoints, `--load_dir` / `--set_step`, and the FID
eval block (real dump, EMA renders at min(128, target_size), FID through
InceptionV3 in this process on its device, `fid.txt`). On the card the
renders and the G phase run through the port's kernels
(train/loop.py::train_step).

Randomness comes from torch.Generators seeded by (--seed, purpose): the
state from --seed, the fixed grids from tags 1 and 2, step s's draws from
tag 10_000 + s, so a resumed run draws what the straight run draws. The
loader of a stage starts at the stage's first step and skips the batches a
resumed run has already taken, so resuming replays the straight run's
data too.

Both model families train: the latent-grid family (e.g. --curriculum
CelebA_latent_grid, a CelebA jpg glob) renders its samples and FID images
without psi (its FiLM is per point: there is no W-space average), writes
RGB sheets only and a grid generator.npz, and every render takes the torch
route. Not ported: --multihost / --coordinator / --num_processes /
--process_id (DDP over NCCL, ROADMAP A4) raise.

Usage:
  python -m fenerf_tpu_torch.apps.train \
      --curriculum CelebA_double_semantic_texture_embedding_256_dim_96 \
      --output_dir output/run1 --data_root data/celebahq_mask [--device cuda]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time

A4 = ("multi-process training (DDP over NCCL, train/sharding.py) is not "
      "ported yet: ROADMAP A4")


def _seeded(device, seed: int, tag: int):
    """A torch.Generator on `device` for (seed, tag)."""
    import torch

    return torch.Generator(device=device).manual_seed(
        seed * 1_000_003 + tag)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--curriculum", required=True)
    p.add_argument("--output_dir", default="output/debug")
    p.add_argument("--data_root", default=None,
                   help="overrides the curriculum's dataset_path")
    p.add_argument("--total_steps", type=int, default=None)
    p.add_argument("--load_dir", default="")
    p.add_argument("--set_step", type=int, default=None)
    p.add_argument("--sample_interval", type=int, default=2000)
    p.add_argument("--model_save_interval", type=int, default=5000)
    p.add_argument("--eval_freq", type=int, default=5000)
    p.add_argument("--num_eval_imgs", type=int, default=2048)
    p.add_argument("--num_real_imgs", type=int, default=8000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--field_overrides", default="",
                   help='JSON dict, e.g. {"hidden_dim": 64} (debug runs)')
    p.add_argument("--stage_overrides", default="",
                   help='JSON dict overriding stage meta, e.g. '
                        '{"batch_size": 4, "img_size": 16} (debug runs)')
    p.add_argument("--profile_steps", default="",
                   help="'start:stop' step range to trace with "
                        "torch.profiler into <output_dir>/profile")
    p.add_argument("--multihost", action="store_true",
                   help="not ported yet (ROADMAP A4)")
    p.add_argument("--coordinator", default=None,
                   help="not ported yet (ROADMAP A4)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="not ported yet (ROADMAP A4)")
    p.add_argument("--process_id", type=int, default=None,
                   help="not ported yet (ROADMAP A4)")
    p.add_argument("--full_batch", action="store_true",
                   help="run the G phase (and the D-phase fakes) over the "
                        "full batch while computing the exact "
                        "split-structured objective (StageMeta.full_batch)")
    p.add_argument("--grad_rays", type=float, default=1.0,
                   help="G-phase gradient subset of rays (< 1.0 enables; "
                        "the reference's part_forward, generators.py:"
                        "858-910: every ray renders, a random fraction "
                        "carries gradients)")
    p.add_argument("--device", default="cuda",
                   help="torch device (raises if CUDA is requested and "
                        "absent)")
    args = p.parse_args(argv)
    if (args.multihost or args.coordinator or args.num_processes
            or args.process_id is not None):
        raise NotImplementedError(A4)

    import torch

    from fenerf_tpu_torch.apps.common import route_line, save_generator
    from fenerf_tpu_torch.data.celeba_mask import (iterate_batches,
                                                   make_dataset)
    from fenerf_tpu_torch.eval import fid as fidlib
    from fenerf_tpu_torch.models import generator as gen
    from fenerf_tpu_torch.nn import fields
    from fenerf_tpu_torch.ops import film_mlp
    from fenerf_tpu_torch.train import loop as looplib
    from fenerf_tpu_torch.train.curriculum import get_curriculum
    from fenerf_tpu_torch.utils import checkpoint as ckpt
    from fenerf_tpu_torch.utils.image import (make_grid, mask2color,
                                              save_image_grid, save_png)
    from fenerf_tpu_torch.utils.profiling import StatsCollector

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass --device cpu to "
                           "train on the CPU")
    os.makedirs(args.output_dir, exist_ok=True)
    cur = get_curriculum(args.curriculum)
    fo = tuple(sorted(json.loads(args.field_overrides).items())) \
        if args.field_overrides else ()
    so = json.loads(args.stage_overrides) if args.stage_overrides else {}

    def meta_at(step):
        m = cur.at_step(step)
        repl = dict(so)
        if args.data_root:
            repl["dataset_path"] = args.data_root
        if fo:
            repl["field_overrides"] = fo
        if args.full_batch:
            repl["full_batch"] = True
        if args.grad_rays < 1.0:
            repl["grad_rays"] = args.grad_rays
        return dataclasses.replace(m, **repl) if repl else m

    meta = meta_at(0)
    state = looplib.init_train_state(meta, seed=args.seed, device=dev)
    start_step = 0
    if args.load_dir:
        path = os.path.join(args.load_dir, "train_state.npz")
        state = ckpt.load(path, state)
        start_step = int(state.step)
        print(f"resumed from {path} at step {start_step}")
    if args.set_step is not None:
        state = state._replace(step=args.set_step)
        start_step = args.set_step

    # fixed grids for visual checks (reference fixed_z, train...py:113-114)
    fixed_zg = torch.randn((25, meta.latent_geo_dim),
                           generator=_seeded(dev, args.seed, 1), device=dev)
    fixed_za = torch.randn((25, meta.latent_app_dim),
                           generator=_seeded(dev, args.seed, 2), device=dev)

    # options dump (reference options.txt, :189-197)
    with open(os.path.join(args.output_dir, "options.txt"), "w") as f:
        f.write(f"{vars(args)}\n\n{meta}\n")
    metrics_log = open(os.path.join(args.output_dir, "metrics.jsonl"), "a")

    data_iter = None
    stage_meta = None
    dataset = None
    total = args.total_steps or cur.end_step
    step = start_step
    t_last = time.time()
    stats = StatsCollector()
    prof_range = (tuple(int(x) for x in args.profile_steps.split(":"))
                  if args.profile_steps else None)
    profiler = contextlib.ExitStack()
    load_s = []      # each batch's assembly time (host clock)

    def eval_render(params, fcfg, ecfg, zg, za, psi, generator,
                    noise_std=0.0):
        """EMA / eval render of either family: psi truncation through the
        average W for the film family; the grid family renders from z
        alone, without psi."""
        if gen.is_grid_config(fcfg):
            return gen.render_grid_from_z(params, fcfg, ecfg, zg,
                                          noise_std=noise_std,
                                          generator=generator)
        avg = fields.avg_film(params, fcfg, _seeded(dev, 0, 7))
        return gen.render_truncated(params, fcfg, ecfg, zg, za, avg,
                                    psi=psi, noise_std=noise_std,
                                    generator=generator)

    @torch.no_grad()
    def sample_grids(state, meta, step):
        fcfg = meta.field_config()
        ecfg = meta.eval_render_config(
            img_size=min(128, meta.target_size), h_stddev=0.0, v_stddev=0.0,
            sample_dist=None, ray_chunk=4096,
            backend=film_mlp.backend_for(fcfg, dev))
        # the tilted pair renders the same latents from h_mean + 0.5 (the
        # reference saves fixed / tilted / fixed_ema / tilted_ema / random,
        # train_double_latent_semantic.py:466-521); ema2 is checkpointed
        # but never sampled, as in the reference
        tilted = dataclasses.replace(ecfg, h_mean=ecfg.h_mean + 0.5)
        g_rand = _seeded(dev, args.seed, step)
        for tag, params, cfg_r, psi, zg, za in (
            ("fixed", state.g_params, ecfg, 1.0, fixed_zg, fixed_za),
            ("tilted", state.g_params, tilted, 1.0, fixed_zg, fixed_za),
            ("fixed_ema", state.ema.params, ecfg, 1.0, fixed_zg, fixed_za),
            ("tilted_ema", state.ema.params, tilted, 1.0, fixed_zg,
             fixed_za),
            ("random_ema", state.ema.params, ecfg, 0.7,
             torch.randn(fixed_zg.shape, generator=g_rand, device=dev),
             torch.randn(fixed_za.shape, generator=g_rand, device=dev)),
        ):
            # the CURRENT annealed nerf noise, as the reference passes it
            # (train...py:471): early grids are noise-lit
            out = eval_render(params, fcfg, cfg_r, zg, za, psi,
                              _seeded(dev, 0, 0),
                              noise_std=meta.nerf_noise(step))
            pix = out["pixels"].float().cpu().numpy()
            save_image_grid(
                os.path.join(args.output_dir, f"{step}_img_{tag}.png"),
                pix[:, -3:])
            if fcfg.n_labels:
                save_png(
                    os.path.join(args.output_dir, f"{step}_seg_{tag}.png"),
                    make_grid(mask2color(pix[:, :-3]), nrow=5))

    while step < total:
        m = meta_at(step)
        if stage_meta is None or m != stage_meta:
            stage_meta = m
            # which field-kernel route serves this stage, by the policy the
            # step itself dispatches through
            fc = m.field_config()
            g_bk = film_mlp.backend_for(fc, dev, train=True)
            kpath = f"{g_bk}(G)+{film_mlp.backend_for(fc, dev)}(D)"
            route = route_line(fc, dataclasses.replace(
                m.render_config(), backend=g_bk), dev)
            print(f"[stage] step={step} img={m.img_size} bs={m.batch_size} "
                  f"steps/ray={m.num_steps} split={m.batch_split}"
                  f"{'(full_batch)' if m.full_batch else ''} "
                  f"kernel={kpath} G: {route}", flush=True)
            if m.dataset != "CelebA":
                dataset = make_dataset(m.dataset, m.dataset_path, m.img_size,
                                       background_mask=m.background_mask)
            else:
                dataset = make_dataset(m.dataset, m.dataset_path, m.img_size)
            # the stage's loader seeded by its first step (the JAX
            # loader's seed + step); a run resumed inside the stage skips
            # the batches the straight run took before `step`
            first = cur.stage_start(step)
            if args.set_step is not None and step == start_step:
                first = step
            if data_iter is not None:
                data_iter.close()   # stops its loader processes
            data_iter = iterate_batches(dataset, m.batch_size,
                                        seed=args.seed + first,
                                        skip=step - first, timings=load_s)

        t_data = time.perf_counter()
        imgs, labels = next(data_iter)
        wait_ms = (time.perf_counter() - t_data) * 1e3
        imgs = torch.from_numpy(imgs).to(dev)
        labels = torch.from_numpy(labels).to(dev)
        scal = looplib.StepScalars(
            alpha=torch.tensor(cur.alpha(step), device=dev),
            noise_std=torch.tensor(m.nerf_noise(step), device=dev),
            topk_frac=torch.tensor(m.topk_fraction(step), device=dev))
        if prof_range and step == prof_range[0]:
            from fenerf_tpu_torch.utils.profiling import trace

            profiler.enter_context(
                trace(os.path.join(args.output_dir, "profile")))
        state, metrics = looplib.train_step(
            state, imgs, labels, scal, m,
            generator=_seeded(dev, args.seed, 10_000 + step))
        if prof_range and step == prof_range[1]:
            profiler.close()

        if step % args.log_every == 0:
            mvals = {k: float(v) for k, v in metrics.items()}
            # the step's window on the host clock: waiting for the batch,
            # its copy to the device and the step, up to the read of its
            # metrics, which waits for the device
            step_ms = (time.perf_counter() - t_data) * 1e3
            stats.report(**mvals)
            # divergence watchdog: halt and keep the last good checkpoint
            # (the reference has no failure detection, SURVEY.md §5)
            bad = [k for k, v in mvals.items() if not math.isfinite(v)]
            if bad:
                ckpt.save(os.path.join(args.output_dir,
                                       "train_state_diverged.npz"), state)
                data_iter.close()
                raise SystemExit(
                    f"non-finite metrics {bad} at step {step}; state saved "
                    f"to train_state_diverged.npz (resume from the last "
                    f"periodic checkpoint with --load_dir)")
            dt = time.time() - t_last
            t_last = time.time()
            rate = args.log_every * m.batch_size / dt if step else 0.0
            # the host time of the loader's latest batch (one worker
            # process builds a batch), and how long this step waited for one
            line = {"step": step, "imgs_per_sec": round(rate, 2), **mvals,
                    "step_ms": round(step_ms, 2),
                    "loader_ms": round(load_s[-1] * 1e3, 2),
                    "data_wait_ms": round(wait_ms, 2)}
            if dev.type == "cuda":
                line["peak_hbm_gb"] = round(
                    torch.cuda.max_memory_allocated(dev) / 2 ** 30, 2)
            print(json.dumps(line), flush=True)
            metrics_log.write(json.dumps(line) + "\n")
            metrics_log.flush()

        step += 1

        if args.model_save_interval > 0 \
                and step % args.model_save_interval == 0:
            ckpt.save(os.path.join(args.output_dir, "train_state.npz"), state)
            # m.field_overrides carries the effective overrides
            if m.family == "grid":
                fkw = {"z_dim": m.latent_geo_dim, **dict(m.field_overrides)}
            else:
                fkw = {"z_geo_dim": m.latent_geo_dim,
                       "z_app_dim": m.latent_app_dim,
                       "n_labels": m.output_dim - 4,
                       **dict(m.field_overrides)}
            save_generator(
                os.path.join(args.output_dir, "generator.npz"),
                state.g_params, state.ema.params, state.ema2.params,
                m.model, step, field_kwargs=fkw)
        if args.sample_interval > 0 and step % args.sample_interval == 0:
            sample_grids(state, m, step)

        if args.eval_freq > 0 and step % args.eval_freq == 0:
            _et0 = time.perf_counter()
            real_dir = os.path.join(args.output_dir, "evaluation/real")
            gen_dir = os.path.join(args.output_dir, "evaluation/generated")
            fidlib.setup_evaluation(dataset, real_dir,
                                    target_size=m.target_size,
                                    num_real=args.num_real_imgs)
            _et1 = time.perf_counter()
            print(f"[eval-t] setup_evaluation_s={_et1 - _et0:.3f}",
                  flush=True)
            fcfg = m.field_config()
            ecfg = m.eval_render_config(
                img_size=min(128, m.target_size), ray_chunk=4096,
                backend=film_mlp.backend_for(fcfg, dev))

            @torch.no_grad()
            def render_batch(g, n):
                zg = torch.randn((n, m.latent_geo_dim), generator=g,
                                 device=dev)
                za = torch.randn((n, m.latent_app_dim), generator=g,
                                 device=dev)
                out = eval_render(state.ema.params, fcfg, ecfg, zg, za, 1.0,
                                  g)
                return out["pixels"][:, -3:]

            fidlib.output_images(render_batch, gen_dir,
                                 num_eval=args.num_eval_imgs, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            _et2 = time.perf_counter()
            print(f"[eval-t] output_images_s={_et2 - _et1:.3f} "
                  f"images={args.num_eval_imgs}", flush=True)
            try:
                fid = fidlib.calculate_fid(
                    real_dir, gen_dir,
                    feature_fn=fidlib.inception_features(device=dev))
                with open(os.path.join(args.output_dir, "fid.txt"),
                          "a") as f:
                    f.write(f"\n{step}:{fid}")
                n_scored = sum(len(os.listdir(d))
                               for d in (real_dir, gen_dir))
                print(f"[eval-t] calculate_fid_s="
                      f"{time.perf_counter() - _et2:.3f} images={n_scored}",
                      flush=True)
                print(f"[fid] step={step} fid={fid:.3f}", flush=True)
            except FileNotFoundError as e:
                print(f"[fid] skipped: {e}")

    profiler.close()
    if data_iter is not None:
        data_iter.close()
    ckpt.save(os.path.join(args.output_dir, "train_state.npz"), state)
    stats.dump(os.path.join(args.output_dir, "stats.json"))
    metrics_log.close()
    print("training complete")
    return state


if __name__ == "__main__":
    main()
