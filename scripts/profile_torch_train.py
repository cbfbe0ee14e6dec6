"""Where the time of one training step of the PyTorch/CUDA port goes, on an
NVIDIA GPU, at stage 0 of the flagship curriculum
(CelebA_double_semantic_texture_embedding_256_dim_96: bs 24, split 4, 32^2,
24+24 steps, hidden 256, 96^3x32 texture grid; random weights from a seed,
synthetic reals).

  python scripts/profile_torch_train.py [--steps 5] [--out FILE]

The ray kernels follow FENERF_RAY_KERNELS as in the trainer (default
never); run it once with each setting to compare. The table fold runs its
kernel on the card always.

Prints:
  * ms per step on the host clock with a sync (median of --steps after a
    warm-up step);
  * the step's phases, each run alone with the port's own functions and
    timed with CUDA events: D fakes (one D phase's fake renders), D loss
    with R1 and its gradient (D_img), one G microbatch forward (render +
    critics) and its backward, the table fold and the three optimizer
    steps;
  * the cost of the critics' exactness (ROADMAP F6): each D phase (loss
    with R1 and its gradient) and a G microbatch's backward as the trainer
    runs them, TF32 off in every direction, against the same work with
    only the critics' forward pinned and their backwards on the process's
    cuDNN TF32 (how the trainer ran them before F6 was closed);
  * a torch.profiler trace of one step: device time by kernel group (the
    field forward kernel, the backward kernels, cuDNN convolutions, the
    texture-table gather / scatter, everything else) and the device's busy
    share of the traced step. The full kernel table goes to --out.

cuDNN's flags are left as torch sets them (TF32 allowed), as they are under
apps/train.py: the trainer pins TF32 off around the critics itself
(utils/precision.py::exact_convs).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from fenerf_tpu_torch.core.grid_sample import (build_zexp_table,  # noqa: E402
                                               zexp_table_adjoint)
from fenerf_tpu_torch.nn import fields  # noqa: E402
from fenerf_tpu_torch.train import loop  # noqa: E402
from fenerf_tpu_torch.train.curriculum import CURRICULA  # noqa: E402
from fenerf_tpu_torch.utils.precision import exact_convs  # noqa: E402

TEXTURE = "CelebA_double_semantic_texture_embedding_256_dim_96"


def reals(gen, b, size, dev):
    up = lambda t: torch.nn.functional.interpolate(
        t, size=(size, size), mode="bilinear", align_corners=False)
    imgs = up(torch.rand(b, 3, 4, 4, generator=gen, device=dev) * 2 - 1)
    lab = up(torch.rand(b, 18, 8, 8, generator=gen, device=dev)).argmax(1)
    labels = torch.nn.functional.one_hot(lab, 18).permute(0, 3, 1, 2)
    return imgs.clamp(-1, 1), labels.float() * 2 - 1


def event_ms(fn, iters=3):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def group_of(name: str) -> str:
    n = name.lower()
    if "film_mlp_kernel" in n:
        return "field forward kernel (film_mlp)"
    if any(k in n for k in ("bwd_rows_kernel", "dw_kernel", "reduce_kernel")):
        return "field backward kernels (film_mlp_bwd)"
    if "ray_resample_kernel" in n or "ray_finalize_kernel" in n:
        return "ray kernels (ray_resample, ray_finalize)"
    if "fold_zexp_kernel" in n:
        return "table-fold kernel (fold_zexp)"
    if any(k in n for k in ("conv", "cudnn", "xmma", "implicit", "wgrad",
                            "dgrad", "fprop", "nchw", "nhwc")):
        return "convolutions (cuDNN, D and its R1 / G gradients)"
    if any(k in n for k in ("index", "scatter", "gather")):
        return "texture-table gather / scatter and other indexing"
    return "other (compositing, sampling, optimizer, elementwise)"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print("FENERF_RAY_KERNELS="
          + os.environ.get("FENERF_RAY_KERNELS", "never"))
    cur = CURRICULA[TEXTURE]
    meta = cur.at_step(0)
    state = loop.init_train_state(meta, seed=0, device="cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    as_t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    scal = loop.StepScalars(as_t(1.0), as_t(0.5), as_t(0.9))

    def step():
        nonlocal state
        imgs, labels = reals(gen, meta.batch_size, meta.img_size, dev)
        state, m = loop.train_step(state, imgs, labels, scal, meta,
                                   generator=gen)
        return m

    step()
    times = []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    med = times[len(times) // 2]
    print(f"step: median {med:.2f} ms over {args.steps} (min {times[0]:.2f},"
          f" max {times[-1]:.2f}); {meta.batch_size / med * 1e3:.2f} "
          f"images/s")

    # ---- phases alone, CUDA events ------------------------------------
    fcfg, rcfg = meta.field_config(), meta.render_config()
    draws = loop.make_step_draws(gen, meta, meta.batch_size,
                                 scal.noise_std, dev)
    with torch.no_grad():
        table = build_zexp_table(state.g_params["grid"], torch.bfloat16)
    rp = {**state.g_params, fields.GRID_TABLE_KEY: table}
    zg, za = draws.z_img
    imgs, labels = reals(gen, meta.batch_size, meta.img_size, dev)
    ph = {}
    ph["table build"] = event_ms(lambda: build_zexp_table(
        state.g_params["grid"], torch.bfloat16))
    ph["D fakes (one D phase, 4 renders)"] = event_ms(
        lambda: loop._render_fakes(rp, fcfg, rcfg, zg, za, draws.fakes_img,
                                   scal.noise_std))
    fake, pos, _ = loop._render_fakes(rp, fcfg, rcfg, zg, za,
                                      draws.fakes_img, scal.noise_std)

    def flags(exact):
        # exact: the trainer's `with` around a phase's loss and gradients;
        # else the critics' forward alone pins TF32 off (nn/discriminators)
        return (exact_convs(deterministic=False) if exact
                else contextlib.nullcontext())

    def d_phase(kind, exact=True):
        seg = kind == "seg"
        with flags(exact):
            d = loop._leaf_copy(state.d_seg_params if seg
                                else state.d_img_params)
            loss = loop._d_loss(
                d, meta.disc_seg_config() if seg else meta.disc_img_config(),
                meta, torch.cat([labels, imgs], dim=1) if seg else imgs,
                fake if seg else fake[:, -3:], zg, za, pos, scal.alpha)
            loop._grads(loss, d)

    before = {}
    for kind in ("img", "seg"):
        ph[f"D_{kind} loss with R1 + gradient"] = event_ms(
            lambda: d_phase(kind))
        before[f"D_{kind}"] = event_ms(lambda: d_phase(kind, exact=False))
    g_rcfg = dataclasses.replace(rcfg, backend="kernel_train")
    bs = meta.batch_size // meta.batch_split
    gz = [z[:bs] for z in draws.z_g]

    def g_fwd(exact=True):
        with flags(exact):
            p = loop._leaf_copy(rp)
            return p, loop._g_loss(p, state.d_img_params, state.d_seg_params,
                                   fcfg, g_rcfg, meta, gz[0], gz[1], scal,
                                   1, draws.g_renders[0])[0]

    ph["G microbatch forward (render + critics)"] = event_ms(
        lambda: g_fwd())
    holder = []

    def g_bwd(exact):
        p, loss = holder.pop()
        with flags(exact):
            loop._grads(loss, p)

    def g_bwd_timed(iters=3, exact=True):
        total = 0.0
        for i in range(iters + 1):
            holder.append(g_fwd(exact))
            torch.cuda.synchronize()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            g_bwd(exact)
            e.record()
            torch.cuda.synchronize()
            if i:
                total += s.elapsed_time(e)
        return total / iters

    ph["G microbatch backward"] = g_bwd_timed()
    before["G backward"] = g_bwd_timed(exact=False)
    dtable = torch.zeros_like(table, dtype=torch.float32)
    ph["table fold (zexp_table_adjoint)"] = event_ms(
        lambda: zexp_table_adjoint(dtable, tuple(
            state.g_params["grid"].shape)))
    for k, v in ph.items():
        print(f"phase {k}: {v:.2f} ms")
    print("a step runs: table build once, 2 D fake phases, D_img and D_seg "
          "losses, 4 G microbatches forward + backward, one fold, three "
          "optimizer steps and two EMA updates")
    cost = {"D_img": ph["D_img loss with R1 + gradient"] - before["D_img"],
            "D_seg": ph["D_seg loss with R1 + gradient"] - before["D_seg"],
            "G backward": ph["G microbatch backward"] - before["G backward"]}
    step_cost = (cost["D_img"] + cost["D_seg"]
                 + meta.batch_split * cost["G backward"])
    print("F6, the critics' backwards on the process's cuDNN TF32 (before) "
          "-> TF32 off in every direction (the trainer): " + ", ".join(
              f"{k} {before[k]:.2f} -> {before[k] + v:.2f} ms"
              for k, v in cost.items())
          + f"; per step (D_img + D_seg + {meta.batch_split} G backwards) "
            f"{step_cost:+.2f} ms")

    # ---- one traced step ------------------------------------------------
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups: dict[str, float] = {}
    total = 0.0
    rows = []
    from torch.autograd import DeviceType

    for evt in prof.key_averages():
        # device kernels only (CPU ops carry their kernels' time as well)
        if evt.device_type != DeviceType.CUDA:
            continue
        dt = evt.self_device_time_total / 1e3
        if dt <= 0:
            continue
        total += dt
        groups[group_of(evt.key)] = groups.get(group_of(evt.key), 0.0) + dt
        rows.append((dt, evt.count, evt.key))
    print(f"traced step: wall {wall:.2f} ms, device kernel time "
          f"{total:.2f} ms, busy share {total / wall:.3f}")
    for k, v in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {k}: {v:.2f} ms ({v / max(total, 1e-9) * 100:.1f}%)")
    rows.sort(reverse=True)
    table_txt = "\n".join(f"{dt:10.3f} ms {n:6d}x  {name}"
                          for dt, n, name in rows)
    print("top kernels:\n" + "\n".join(table_txt.splitlines()[:15]))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(table_txt + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
