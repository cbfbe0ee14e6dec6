"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Drives the port's main paths at the full width of the flagship model
TextureEmbeddingPiGAN256SEMANTICDISENTANGLE_DIM_96 with random weights from
a seed: serving (fenerf_tpu_torch.apps.serve) through the hand-written CUDA
field kernel (ops/csrc/film_mlp.cu); the editing workflow's entry points
(apps.render_multiview, apps.extract_shapes, apps.invert) through it and
the backward kernels, and its mask half (apps.prepare_segmaps on BiSeNet,
apps.edit_mask, apps.paint_ui, apps.edit_log_video, apps.eval_metrics and
render_multiview --hd with the neural renderers) around an inversion; free-viewpoint video (apps.render_video) of the film
family through it and of the latent-grid family SPATIALSIRENGRID, at its
published widths, through the ray kernels, and the grid family's
multiview, shape and serving paths; and GAN training
(fenerf_tpu_torch.train.loop) through it and the hand-written backward
kernels (ops/csrc/film_mlp_bwd.cu) and the table-fold kernel
(ops/csrc/zexp_fold.cu), also through the trainer's entry point
(fenerf_tpu_torch.apps.train: a synthetic CelebAMask-HQ tree of committed
JPEGs decoded by the port's host codec, checkpoints and resume, the FID
protocol on stand-in InceptionV3 weights, the 64^2 stage), and the
latent-grid family's training at its published widths; and both again
with the switch of the fused per-ray kernels on (FENERF_RAY_KERNELS=auto: ops/csrc/ray_finalize.cu); and the
ceiling-probe scripts (scripts/profile_torch_{mxu_chain,epilogue_overlap,
dma_gather}.py) through their kernels (ops/csrc/mxu_chain.cu,
ops/csrc/mxu_wide.cu, ops/csrc/dma_gather.cu); and reference-layout
checkpoints through the converter (apps.convert_checkpoint) rendered
through the field and ray kernels. Every kernel is built here from the checkout.

Phases (any failure exits non-zero):
  1. card and build: card name and power limit, torch / CUDA versions,
     all seven kernel libraries built in parallel (one nvcc each) beside
     the host codec (data/native/codec.cpp, c++); per
     field, chain and gather library the registers and spills of each
     kernel and its count of HGMMA (wgmma) and HMMA (mma.sync / wmma)
     instructions in the SASS (cuobjdump), failing if film_mlp's kernel,
     film_mlp_bwd's row or dW kernel, mxu_chain's chain kernel or
     mxu_wide's wide kernel issues no HGMMA or any HMMA, if the gather's
     overlap kernel (the one left on wmma) issues no HMMA, or if ptxas
     notes (C7520 / C7512) say it serialized a library's wgmma products;
     and the gather kernel's bulk copies (UBLKCP), failing without them or
     with any per-thread cp.async piece (LDGSTS); the ray library's
     kernels likewise, failing if the finalize kernel has no bulk copy;
  2. the forward kernel against its plain torch version at the serving
     shape (B=1, N=4096x48), two ragged ones (N not a multiple of the
     tile; B=2, N=20000 has tiles that run from one batch element into the
     next after a tile of the same CTA lay wholly in the first), the
     training renders' shape (B=6, N=32x32x24) and two whose every tile
     touches three or more batch elements (B=3, N=37; B=5, N=20: the
     FiLM rows from device memory), and invert's (B=1, N=128x128x24, also
     an eval render's block of 8192 rays x 48), max |diff| and the
     time of each side, and as context_ms the same bf16 products through
     torch.matmul (the product path's yardstick);
  3. the ray kernels against their plain versions at every block a main
     path gives them (RAY_CHECK_SHAPES): the serving block (B=1, R=4096,
     48+48 samples, no noise), the training microbatch (B=6, R=1024,
     24+24, sigma noise), a ragged shape, the 64^2 stage's G microbatch
     (B=12, R=4096, 24+24, sigma noise), a block of invert's eval render
     (B=1, R=8192, 48+48), render_video's film block (B=1, R=4096, 24+24,
     C=22) and the grid family's video and sheet blocks (C=4 outputs,
     24+24 and 48+48), each without a fill (as the render hands them) and,
     where its path fills, with the path's fill in the epilogue (seg
     padding, white background); no softmax: fine z, comp, depth,
     weights_sum; kernel (CUDA events around the wrapper; the kernel's
     device time in the profiler; the wrapper's host time per call),
     plain and torch-route times; and ray_finalize_vjp's cotangents
     against the torch route's autograd at the training shape;
  4. the fold kernel against its plain version at the flagship grid
     (32 x 96^3) with an f32 and a bf16 cotangent: relative error, bitwise
     equality, times; and the library call that computes the same fold
     (a one-hot conv3d, f32);
  5. serving, once per ray route (FENERF_RAY_KERNELS=never, then auto): a
     full-width .npz checkpoint, build_renderer at the serve defaults, HTTP
     rgb / seg requests on a batch-1 server and 6 concurrent requests on a
     --batch 4 server; the kernels of the route launched (4 + 4 ray-kernel
     launches per render with the switch on), no plain version called;
     ms/request and rays/s of both routes; a kind=depth PNG (the jet
     table, no cv2); then, on the same checkpoint, the editing workflow:
     a. render_multiview at its defaults (256^2, 24x2 steps, hierarchical,
        psi 0.7), two seeds per ray route: the sheets' PNG sizes, the
        launches of the route's kernels, ms per 5-view sheet, one view of
        the ray kernels against the torch ray route and of the field
        kernel against the field's torch route at bf16 (phase 6's 2e-2);
     b. extract_shapes at 256^3 (the field's torch route in f32, as the
        JAX package's XLA route; no kernel launched): the .mrc read back
        (shape, finite), a non-empty mesh of it inside the cube at an iso
        level inside the volume's range (the CLI's mesher), seconds for
        the volume and the mesh;
     c. invert at 128^2 x 24 steps, 60 iterations, eval every 20, ray
        kernels on, --lambda_norm 0, on the same weights with sigma bias
        +5, against the port's own render (PNG pair) at the CLI's init W
        plus a known offset: the steps' losses fall, and the objective
        without the W noise on the fitted path closes at least half of
        its gap to the known offset's; the .npz and mious.npy are
        whole, a warm start keeps the prior W, the launches of both runs;
        the field's VJP w.r.t. the W-space FiLM at a step's shape,
        kernel_train against the torch route (bf16, phase 9's criterion);
        the backward kernels against their plain version at this path's
        shape (B=1, 393,216 rows); one step's loss, kernel route against
        the torch route (bf16, held), and its offset gradients (cosine,
        printed only); ms per iteration and per eval render; the warm
        start renders its reconstruction video (--render_video, 3 frames
        at the eval render's settings) and the .avi is read back;
     d. render_video on a full-width SPATIALSIRENGRID checkpoint (random
        weights, seed 3, sigma bias +20) at its defaults (128^2, 24+24
        steps, 36 frames, front, geo), once per ray route: the .avi read
        back equal to the frames, ms per frame, the launches (4 of each ray
        kernel per frame with the switch on, no field kernel); the kernel
        route's frames against the torch route's (RENDER_TOL); the CLI's
        first frame (ray_chunk 4096) against the same frame rendered whole,
        bit-exact, on each route;
     e. render_video on the serving checkpoint at its defaults, the field
        kernel and the ray kernels on: ms per frame and launches; its
        first, middle and last frames against the same frames on the
        field's and the rays' torch routes at bf16 (RENDER_TOL), rendered
        with the CLI's settings, films, draws and cameras;
     f. the grid checkpoint's other paths: a render_multiview sheet at its
        defaults (ray kernels on), extract_shapes at 256^3 with a mesh (as
        b.), and a request through serve (the torch route, no kernel);
     g. the edit loop, the editing workflow's mask half through the CLIs'
        mains with the ray kernels on and seeded stand-in weights: parse (a
        512^2 face of the serving checkpoint and a committed 1024^2 JPEG
        through prepare_segmaps --size 512 --colorize on a segNet-20Class-
        layout state_dict; BiSeNet's logits card vs CPU, 1e-4 of each
        image's largest, the maps equal where the margin exceeds it; ms per
        parse and per image); edit (edit_mask's switch, scale up and down,
        rect, transfer, simplify held to mask_tools; paint_ui in its own
        process on a free port, /, /labels, /op, /log, /save, the saved map
        equal to apply_op's, the edit log); invert (the JPEG photo against
        the edited map, 30 iterations, an eval every 15, kernel_train:
        finite losses that fall, launches equal to the iterations, eval
        renders and one video frame); replay (edit_log_video --side the
        inversion's render, the .avi equal to log_to_frames); score
        (eval_metrics fid / kid / isc between two directories of 16 renders
        on stand-in Inception weights; a directory against itself below
        1e-3 / 1e-4); HD (render_multiview --hd on a SPATIALSIRENSEMANTICHD
        checkpoint with stand-in nr_img / nr_seg heads, 64^2 features to
        256^2: the view's features on the field kernel vs the torch route
        at bf16, 2e-2; the heads card vs CPU at f32, 1e-4; ms per sheet);
  6. one whole render through the field kernel against the same render
     through its plain version; the ray kernels' render against the torch
     route's; ray-chunked against whole-image rendering on both routes;
  7. the backward kernels against their plain version at the G-phase shape
     (B=6, N=32x32x24), a ragged one, B=2, N=20000 (more tiles than
     SMs, N not a multiple of the tile) and the 64^2 stage's G microbatch
     (B=12, N=64x64x24: 1,179,648 rows, with the peak device memory of the
     kernel's calls), per output group
     (ops/film_mlp_grad.py::bwd_agreement), bitwise equal from run to
     run, their times and as context_ms the recompute, dX and dW bf16
     products through torch.matmul;
  8. training, with the ray kernels off and then on: stage 0 of the
     flagship curriculum (bs 24, split 4, 32^2, 24+24 steps), TRAIN_STEPS
     steps on seeded synthetic reals each; finite losses, ms/step (median
     after the first), images/s, the launches per step of every kernel of
     the route (24 film_mlp, 8 film_mlp_bwd, 1 fold_zexp; on, also 12
     ray_resample and 12 ray_finalize), no plain version called;
  9. G's gradient through the kernels against the torch route (bf16): the
     field's vector-Jacobian product at the G shape, held to the JAX
     package's criterion; and, printed as context, whole G-microbatch
     render gradients at the initial and the trained state;
 9b. the trainer's CLI (apps.train.main in this process): the codec
     built here against the fixture set's decoded.sha256; a synthetic
     CelebAMask-HQ tree (the 8 committed 1024^2 JPEGs in turn, 48 pairs,
     512^2 label PNGs from the port's encoder); stage 0 of the flagship
     curriculum (bs 24, split 4, 32^2) for 6 steps with checkpoints and
     samples every 3 and the FID protocol at step 6 (64 EMA renders at
     128^2, the real dump, InceptionV3 on stand-in weights), then
     --load_dir on the same directory to step 8, then the 64^2 stage
     (--set_step 20000, bs 48, split 4) for 4 steps with the ray kernels
     on, then stage 0 for 2 steps with --grad_rays 0.5 and DiffAugment
     ("color,translation,cutout"); finite losses, the launches of every
     kernel per run (no plain version), the resume at step 6, a G
     microbatch's grad_rays render on the kernels equal to the
     grad_rays = 1 render (1e-6), a finite FID, the real dump against
     itself below 1e-3, Inception features on the card against the CPU;
     ms/step (the CLI's step window, its wait for data included) and
     images/s at 32^2 and 64^2, the loader's host ms per batch, ms per
     rendered and per Inception-scored image, the Frechet distance's
     seconds, peak memory;
 9c. the latent-grid family's training (grid train): CelebA_latent_grid's
     stage 0 at full width (SPATIALSIRENGRID at its published widths; bs
     48, split 16, 64^2, 12+12 steps), 3 train_step calls on seeded
     synthetic reals with the ray switch on and no kernel launched (the
     JAX trainer runs this family on XLA alone); finite losses, every G
     group and the EMA moved, ms/step, images/s, peak memory; one more
     step under torch.profiler, its device time by group (the plane's
     convolutions, its sampling, the per-point mapping, the FiLM layers'
     products and epilogue / sine, the critics with R1, the rest); the
     field's VJP on 64 rays of a G microbatch, card (cuDNN TF32 allowed
     by the process) against the CPU, per group (phase 9's criterion) and
     the latent plane against the CPU's; then the trainer's CLI on the
     fixture JPEGs as a 48-image CelebA glob, 2 steps with a checkpoint,
     RGB samples and the FID block (64 EMA renders at 128^2, stand-in
     Inception weights), and a 1-step resume, no kernel launched;
 10. the ceiling probes: the three probe scripts at their full shapes (3 timed
     calls per variant; every probe kernel launched, no plain version
     called), then each probe kernel against its plain version at those
     shapes (the chains at 11 layers and width 256 and, wide_t64 and
     wide_t128, at 5 layers and width 512; the FiLM epilogue at
     the field's weight scale over 11 layers and on the script's draw over
     1, plain and folded; every variant of a chain bitwise equal to the
     others; the gather bit-exact with 2 KB and 512 B rows at the probe
     script's rings, and beside the chain over 2 KB and over 16 B rows,
     whose difference is what the gather adds beside the chain), timed
     beside the plain version and the library call (index_select, with
     each time's share of the bound; for the chains, the same torch.matmul
     calls in a row, printed as context).

 11. ddp, data-parallel training on the one card: (i) two gloo ranks
     spawned from this script, both on cuda:0 (NCCL refuses two ranks on
     one device), the flagship's stage 0 at full width (24 per rank, 48
     global, split 4, topk 0.6 so that each chunk's kept set spans the
     ranks, ray kernels on) for 2 steps through
     train/sharding.py::train_step_sharded, against the same 2 steps in
     this process on the 48-image batch (the first step's losses 1e-3
     absolute and the G parameters 5e-4: the JAX package's mesh bounds;
     the second step's losses 2e-3 relative), printed beside the witness,
     the same process full-batch on the same draws (only the reduction
     order differs), the ranks' states bit-identical
     (check_replica_consistency), each rank's launches equal to its
     renders and steps; ms per step per rank, the all-reduce's ms, bytes
     and calls per step (gloo on CUDA tensors), peak memory per rank;
     (ii) an NCCL all-reduce at world size 1 and the trainer's CLI over
     NCCL at world size 1 (--coordinator, --num_processes 1, --process_id
     0) on 24 pairs of the fixture tree, 3 steps with a checkpoint;
     (iii) apps.supervise around that CLI (its own processes): the run
     resumes from (ii)'s checkpoint, the trainer's process group is
     killed once metrics.jsonl shows its first step (3), the relaunch
     resumes from the run's own checkpoint and ends at step 4; the events
     launched, exit, relaunching, launched, done. No speed across GPUs is
     shown;
 12. sharded: render_image_sharded and render_grid_sharded at
     render_multiview's 256^2 (48 + 48 steps, ray_chunk 4096) in 4 strips
     of cuda:0 against the whole render, bit for bit on both ray routes;
     eval_volume_sharded and eval_volume_grid_sharded at 256^3 in 4 slabs
     against the whole lattice, bit for bit; render_multiview,
     render_video (3 frames) and extract_shapes (128^3) with --shard_rays
     over 4 strips of cuda:0 (on this one-GPU machine the CLIs' own
     --shard_rays takes 1) against their plain runs, the film family
     through all three and the grid family through the last two.
 13. convert: the film flagship (the serving weights), SPATIALSIRENGRID and
     SPATIALSIRENSEMANTICHD with its nr_img / nr_seg heads, each pickled as
     the reference's trainer saves it (a whole generator module of the
     stand-in reference tree, tests/torch_reference_standins.py, beside
     ema.pth and ema2.pth), converted by apps.convert_checkpoint --model
     auto (three subprocesses started together): every leaf of the three
     trees (and the heads) bit-equal to the params written; render_multiview
     (ray kernels on; 256^2 film and --hd, 128^2 grid) of each converted
     .npz byte for byte equal to the directly written checkpoint's sheets,
     the field and ray kernels launched and no plain version called; the
     SPADE multiscale patch critic at the JAX defaults (input_nc 22, ndf 64,
     3 layers, 3 scales) on 4 x 256^2: every feature map against the CPU's
     (1e-4 of its largest, f32), 5 state-threaded calls' spectral-norm u
     against the CPU's (1e-5), ms per call; align_face on a synthetic
     1024^2 photo through its shrink, crop and pad branches (PIL-exact
     LANCZOS and QUAD in numpy, PIL never imported), then prepare_segmaps'
     BiSeNet on the card on the aligned face with stand-in weights.

Prints each phase's seconds, the card line, a JSON line of per-kernel
results (launches per main path, launches_train_cli, launches_grid_train,
launches_edit, launches_ddp, launches_sharded and launches_convert among
them) and, last,
{"ok": true, "device": {...}}. Exits non-zero without CUDA.
"""
from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import json
import math
import os
import queue
import re
import signal
import statistics
import struct
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from fenerf_tpu_torch.ops.probes import (N_OUT, PEAK_F32_FLOPS, RAY_SHAPES,
                                         bound_ms, card, device_ms, host_us,
                                         ray_bounds, ray_inputs, time_ms)

FLAGSHIP = "TextureEmbeddingPiGAN256SEMANTICDISENTANGLE_DIM_96"
# kernel vs plain version: both round every matmul operand to bf16 and
# accumulate in f32; they differ in summation order only (bf16 level, as
# the JAX package's kernel test, tests/test_film_mlp_kernel.py:55)
KERNEL_TOL = 2e-2
# whole render, kernel field vs plain-version field, pixels in [-1, 1]: the
# field difference above, passed through importance sampling and
# compositing
RENDER_TOL = 2e-2
SERVE = dict(image_size=128, num_steps=24, ray_step_multiplier=2, fov=12.0,
             fill_mode="seg_padding_background", fill_color="black",
             ray_chunk=4096, use_ema=True)
SIGMA_BIAS = 20.0   # makes the random volume opaque (as tests/test_apps.py)
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def log(*a):
    print(*a, flush=True)


def phase_card():
    from fenerf_tpu_torch.ops import build, dma_gather, film_mlp
    from fenerf_tpu_torch.ops import film_mlp_grad, mxu_chain, ray_finalize
    from fenerf_tpu_torch.ops import zexp_fold

    log(card())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    from fenerf_tpu_torch.data import native_loader

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        # the host codec (c++) beside the nvcc builds
        codec = pool.submit(native_loader.library)
        build.build(build.KERNELS)
        codec.result()
    for mod in (film_mlp, film_mlp_grad, ray_finalize, zexp_fold, mxu_chain,
                dma_gather):
        mod._load_library()
    mxu_chain._load_library("mxu_wide")
    log(f"[build] {', '.join(build.KERNELS)} and the host codec ready in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, out in build.BUILD_LOG.items():
        # ptxas notes of each wgmma.fence it inserts would drown the rest
        keep = [ln for ln in out.strip().splitlines() if "(C7519)" not in ln]
        log(f"[build] {name}:\n" + "\n".join(keep))
    phase_sass(build)


# the kernels that must issue wgmma (SASS HGMMA) and no mma.sync / wmma
# (HMMA), by library
HOPPER_KERNELS = {"film_mlp": ("film_mlp_kernel",),
                  "film_mlp_bwd": ("bwd_rows_kernel", "dw_kernel"),
                  "mxu_chain": ("chain_kernel",),
                  "mxu_wide": ("wide_kernel",)}
# the kernels still on wmma (HMMA), by library: the gather's overlapped
# chain (chain.cuh)
WMMA_KERNELS = {"dma_gather": ("gather_overlap_kernel",)}
# the kernels that must move their rows by bulk copies (SASS UBLKCP, the
# 1-D cp.async.bulk) and by no per-thread cp.async piece (LDGSTS), by library
BULK_KERNELS = {"dma_gather": ("gather_kernel",)}
# the kernels that must move their aligned blocks by bulk copies (UBLKCP);
# their 4-byte cp.async pieces (LDGSTS) move the blocks that are not 16-byte
# multiples, so those are printed only
RING_KERNELS = {"ray_finalize": ("ray_finalize_kernel",)}
# (UTMALDG / UTMASTG: the 2-D tensor copies, printed only)
SASS_OPS = ("HGMMA", "HMMA", "UBLKCP", "LDGSTS", "UTMALDG", "UTMASTG")


def phase_sass(build):
    """Registers, spills and the HGMMA / HMMA / UBLKCP / LDGSTS / UTMALDG /
    UTMASTG instruction counts of every kernel of the field, chain, gather
    and ray libraries (cuobjdump); fails if a kernel of HOPPER_KERNELS
    issues no HGMMA or any HMMA, one of WMMA_KERNELS no HMMA, one of
    BULK_KERNELS no UBLKCP or any LDGSTS, or one of RING_KERNELS no
    UBLKCP."""
    import subprocess

    cuobjdump = str(Path(build._nvcc()).with_name("cuobjdump"))
    libs = list(dict.fromkeys((*HOPPER_KERNELS, *WMMA_KERNELS,
                               *BULK_KERNELS, *RING_KERNELS)))

    def dump(lib_flag):
        lib, flag = lib_flag
        return subprocess.run([cuobjdump, flag, str(build._so_path(lib))],
                              capture_output=True, text=True,
                              check=True).stdout

    # every dump at once (one cuobjdump each), then the checks in order
    jobs = [(lib, flag) for lib in libs
            for flag in ("--dump-resource-usage", "-sass")]
    with ThreadPoolExecutor(len(jobs)) as pool:
        dumps = dict(zip(jobs, pool.map(dump, jobs)))
    for lib in libs:
        usage = dumps[lib, "--dump-resource-usage"]
        sass = dumps[lib, "-sass"]
        regs = {}
        name = None
        for line in usage.splitlines():
            m = re.search(r"Function (\S+):", line)
            if m:
                name = m.group(1)
            m = re.search(r"REG:(\d+).*?STACK:(\d+).*?LOCAL:(\d+)", line)
            if m and name:
                regs[name] = tuple(int(x) for x in m.groups())
        counts, opcodes = {}, {}
        name = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = m.group(1)
                counts[name] = dict.fromkeys(SASS_OPS, 0)
                opcodes[name] = set()
            elif name:
                m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_]*)", line)
                if m:
                    opcodes[name].add(m.group(1))
                    if m.group(1) in counts[name]:
                        counts[name][m.group(1)] += 1
        for fn, c in counts.items():
            r, st, lo = regs.get(fn, (-1, -1, -1))
            log(f"[sass] {lib} {fn}: registers {r}, stack {st} B, local "
                f"(spill) {lo} B, " + ", ".join(f"{k} {v}"
                                                for k, v in c.items()))
        for k in HOPPER_KERNELS.get(lib, ()):
            fns = [fn for fn in counts if k in fn]
            if not fns or any(counts[fn]["HGMMA"] == 0 or counts[fn]["HMMA"]
                              for fn in fns):
                raise AssertionError(f"{lib}: {k} must issue HGMMA (wgmma) "
                                     f"and no HMMA: "
                                     f"{ {fn: counts[fn] for fn in fns} }")
        for k in WMMA_KERNELS.get(lib, ()):
            if not any(k in fn and c["HMMA"] > 0 for fn, c in counts.items()):
                raise AssertionError(f"{lib}: {k} issues no HMMA (wmma)")
        for k in BULK_KERNELS.get(lib, ()):
            fns = [fn for fn in counts if k in fn]
            if not fns or any(counts[fn]["UBLKCP"] == 0
                              or counts[fn]["LDGSTS"] for fn in fns):
                raise AssertionError(
                    f"{lib}: {k} must move its rows by bulk copies (UBLKCP) "
                    f"and no cp.async pieces (LDGSTS): {fns}, opcodes "
                    f"{sorted(set().union(*(opcodes[f] for f in fns)))}")
        for k in RING_KERNELS.get(lib, ()):
            fns = [fn for fn in counts if k in fn]
            if not fns or any(counts[fn]["UBLKCP"] == 0 for fn in fns):
                raise AssertionError(
                    f"{lib}: {k} must move its blocks by bulk copies "
                    f"(UBLKCP): {fns}")
        # ptxas serialized every wgmma of a kernel: it still issues HGMMA,
        # one at a time, so only its notes show it
        notes = [ln for ln in build.BUILD_LOG.get(lib, "").splitlines()
                 if "(C7520)" in ln or "(C7512)" in ln]
        if notes:
            raise AssertionError(f"{lib}: ptxas serialized its wgmma:\n"
                                 + "\n".join(notes))


def _flagship_params(dev, seed=0, sigma_bias=SIGMA_BIAS):
    from fenerf_tpu_torch.nn import fields

    cfg = fields.get_config(FLAGSHIP)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = fields.init_field(gen, cfg, device=dev)
    params["sigma_head"]["b"] = params["sigma_head"]["b"] + sigma_bias
    return cfg, params, gen


# the forward kernel's shapes: serving (B=1, N=128^2 x 48 steps), two ragged
# batches (N not a multiple of the tile; at N=20000 a batch element spans
# more tiles than there are SMs), training's renders (a microbatch of 6
# of the stage's 24 fakes, N=32^2 x 24 steps: D fakes and G forward), and
# two whose every tile touches three or more batch elements (the FiLM rows
# read from device memory, not from the staged tables), and invert's (a
# step's render, B=1, N=128^2 x 24 steps; also an eval render's block of
# 8192 rays x 48 steps), and render_video's block (4096 rays x 24 steps)
FWD_SHAPES = ((1, 4096 * 48), (4, 12345), (2, 20000), (6, 32 * 32 * 24),
              (3, 37), (5, 20), (1, 128 * 128 * 24), (1, 4096 * 24))


def phase_kernel(dev) -> dict:
    """The forward kernel against its plain version at FWD_SHAPES. Returns
    the serving shape's times and bound, the worst error over all shapes,
    and each shape's numbers under "shapes"."""
    from fenerf_tpu_torch.nn import fields
    from fenerf_tpu_torch.ops import film_mlp

    cfg, params, gen = _flagship_params(dev)
    params = fields.with_grid_table(params, cfg, torch.bfloat16)
    pack = film_mlp.pack(params, cfg)
    shapes = []
    for b, n in FWD_SHAPES:
        # points inside the box the rays sample (z in [0.88, 1.12])
        pts = (torch.rand(b, n, 3, generator=gen, device=dev) - 0.5) * 0.24
        dirs = torch.nn.functional.normalize(
            torch.randn(b, n, 3, generator=gen, device=dev), dim=-1)
        zg = torch.randn(b, cfg.z_geo_dim, generator=gen, device=dev)
        za = torch.randn(b, cfg.z_app_dim, generator=gen, device=dev)
        fg, fa = fields.field_film(params, cfg, zg, za)
        warped = pts * (2.0 / cfg.box_side)
        gf = fields._grid_feats(params, warped, torch.bfloat16)
        args = (pack, warped, dirs, gf, fg, fa)
        out = film_mlp.film_mlp(*args)
        ref = film_mlp.film_mlp_reference(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError("kernel output is not finite")
        err = (out - ref).abs().max().item()
        ms = time_ms(lambda: film_mlp.film_mlp(*args), iters=10)
        plain_ms = time_ms(lambda: film_mlp.film_mlp_reference(*args),
                           iters=3, warmup=1)
        rows = b * n
        bound, by = bound_ms(
            rows * _flops_per_point(cfg),
            rows * (4 * 3 + 4 * 3 + 2 * cfg.grid_channels
                    + 4 * cfg.output_dim) + pack.weights.numel() * 2)
        context = _products_ms(_fwd_products(pack, rows), dev)
        log(f"[kernel] B={b} N={n} rows={rows} max|kernel-plain|={err:.3e} "
            f"(tol {KERNEL_TOL}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
            f"kernel {rows / ms / 1e3:.1f} Mpts/s "
            f"{rows * _flops_per_point(cfg) / ms / 1e9:.1f} TFLOP/s "
            f"({bound / ms:.1%} of the bound), bound {bound:.3f} ms ({by}); "
            f"context: the same {pack.n_layers} bf16 products through "
            f"torch.matmul {context:.3f} ms")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"kernel disagrees with plain version: {err}")
        shapes.append({"B": b, "N": n, "max_abs_err": err, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": by, "context_ms": context})
    return {**shapes[0], "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "library_ms": None, "shapes": shapes}


def _flops_per_point(cfg) -> int:
    """Matmul FLOPs of the folded field per point (unpadded shapes)."""
    h, g = cfg.hidden_dim, cfg.grid_channels
    k = (3 * h + (cfg.trunk_layers - 1) * h * h                   # trunk
         + h * (1 + cfg.n_labels)                                 # heads
         + (3 + g + h) * h + (cfg.color_layers - 1) * h * h       # color
         + h * cfg.rgb_dim)
    return 2 * k


def _products_ms(shapes, dev, iters=5) -> float:
    """The product path's yardstick: the bf16 products (m, k) @ (k, n) of
    `shapes` through torch.matmul, one after another (cuBLAS; its time is
    context, never used by the port)."""
    gen = torch.Generator(device=dev).manual_seed(9)
    ops = [(torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16),
            torch.randn(k, n, generator=gen, device=dev).to(torch.bfloat16))
           for m, k, n in shapes]

    def run():
        for a, b in ops:
            torch.matmul(a, b)

    ms = time_ms(run, iters=iters)
    del ops
    return ms


def _fwd_products(pack, rows):
    """The forward kernel's products at `rows` points: one per layer of the
    program, (rows, K) @ (K, n_pad)."""
    return [(rows, d[23], d[10]) for d in pack.program.tolist()]


def _bwd_products(pack, rows):
    """The backward's products at `rows` points: every step of the program
    (the recompute and dX = dy W^T) and every dW = x^T dy."""
    from fenerf_tpu_torch.ops import film_mlp_grad as gops

    hd = pack.head
    prog = pack.program.tolist()
    out = []
    for i in range(hd["n_fwd"] + hd["n_bwd"]):
        d = prog[gops.HEAD_INTS + i * gops.STEP_INTS:]
        out.append((rows, d[25], d[10]))
    out += [(lay["k"], rows, lay["n"]) for lay in pack.layers]
    return out


@contextlib.contextmanager
def ray_kernels(mode: str):
    """FENERF_RAY_KERNELS=mode for the block (the port reads it at dispatch
    time)."""
    old = os.environ.get("FENERF_RAY_KERNELS")
    os.environ["FENERF_RAY_KERNELS"] = mode
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("FENERF_RAY_KERNELS", None)
        else:
            os.environ["FENERF_RAY_KERNELS"] = old


def _counted():
    """(kernel wrappers by name, plain versions) of every kernel."""
    from fenerf_tpu_torch.ops import dma_gather as dg
    from fenerf_tpu_torch.ops import film_mlp, film_mlp_grad
    from fenerf_tpu_torch.ops import mxu_chain as mc
    from fenerf_tpu_torch.ops import ray_finalize as rf
    from fenerf_tpu_torch.ops import zexp_fold as zf

    return ({"film_mlp": film_mlp.film_mlp,
             "film_mlp_bwd": film_mlp_grad.film_mlp_bwd,
             "ray_resample": rf.ray_resample, "ray_finalize": rf.ray_finalize,
             "fold_zexp": zf.fold_zexp, "run_chain": mc.run_chain,
             "run_wide": mc.run_wide, "run_epi": mc.run_epi,
             "ring_dma_gather": dg.ring_dma_gather},
            (film_mlp.film_mlp_reference,
             film_mlp_grad.film_mlp_bwd_reference, rf.ray_resample_reference,
             rf.ray_finalize_reference, zf.fold_zexp_reference,
             mc.chain_reference, mc.epi_reference, dg.gather_reference))


def zero_counts():
    kernels, plain = _counted()
    for f in kernels.values():
        f.launches = 0
    for f in plain:
        f.calls = 0


def read_counts() -> tuple[dict, int]:
    """(launches by kernel, plain-version calls in all)."""
    kernels, plain = _counted()
    return ({k: f.launches for k, f in kernels.items()},
            sum(f.calls for f in plain))


# kernel vs plain version, ray kernels: the same additions in the same
# order, differing in exp / log / log1p and in the order of the compositing
# sum over up to 96 terms (f32); the inverse CDF is continuous at bin edges,
# so a flipped comparison moves a fine z only slightly
RAY_TOL = 1e-4
# ray_finalize_vjp's backward against the torch route's autograd: the same
# torch graph on the same inputs
VJP_TOL = 1e-6
# fold kernel vs plain version, relative: the same eight f32 additions in
# the same order (bit-exact expected)
FOLD_TOL = 1e-6
# the library's conv3d vs the plain fold, relative: the same eight terms
# (and zeros) in the order of the algorithm cuDNN picks, f32 with TF32 off
LIBRARY_FOLD_TOL = 1e-5
# Every block a main path gives the ray kernels, (label, B, R, S, sigma
# noise, field outputs C, fills): RAY_SHAPES (ops/probes.py's, shared with
# scripts/profile_torch_ray_kernels.py, as are the draws); one 8192-ray
# block of invert's 256^2 eval render at 48 + 48 steps; render_video's
# 4096-ray block at its defaults (24 + 24) for the film family, and the
# grid family's (C = 4: rgb, sigma) in video and in a render_multiview
# sheet (48 + 48). The render hands the kernel no fill (fill_mode None:
# render_core fills the assembled image once), so each block is held
# without one (the timed case) and, where its path fills, also with the
# path's fill in the kernel's epilogue: seg padding (code 1), white
# background (code 2).
RAY_CHECK_SHAPES = (
    (*RAY_SHAPES[0], N_OUT, (None, "seg_padding_background")),
    *((*shape, N_OUT, (None,)) for shape in RAY_SHAPES[1:]),
    ("64^2 training", 12, 4096, 24, True, N_OUT, (None,)),
    ("invert eval", 1, 8192, 48, False, N_OUT,
     (None, "eval_seg_padding_background")),
    ("film video", 1, 4096, 24, False, N_OUT,
     (None, "eval_seg_padding_background")),
    ("grid video", 1, 4096, 24, False, 4, (None, "eval_white_back")),
    ("grid sheet", 1, 4096, 48, False, 4, (None, "eval_white_back")))


def _device_ms(fn, kernel: str) -> float | None:
    """The kernel's device time in the profiler's trace, or None (logged)
    where the trace keeps no record of it: a reading, not a check."""
    try:
        return device_ms(fn, 20, kernel)
    except RuntimeError as e:
        log(f"[ray] {kernel}: {e}")
        return None


def phase_ray(dev) -> tuple[dict, dict]:
    """The ray kernels against their plain versions at RAY_CHECK_SHAPES,
    timed beside the plain versions and the torch route they replace; and
    ray_finalize_vjp's cotangents against the torch route's autograd.
    Returns (ray_resample, ray_finalize) results: the serving block's
    times and bound, the worst error over all shapes, each shape under
    "shapes"."""
    from fenerf_tpu_torch.core import integrate as integ
    from fenerf_tpu_torch.ops import ray_finalize as rf

    gen = torch.Generator(device=dev).manual_seed(4)
    rows_rs, rows_fin = [], []
    for label, b, r, s, noisy, c1, fills in RAY_CHECK_SHAPES:
        z, sigma, outputs = ray_inputs(gen, dev, b, r, s, c1)
        randn = lambda n: torch.randn(b, r, n, generator=gen, device=dev)
        nz_c, nz_f = (randn(s), randn(2 * s)) if noisy else (None, None)
        u = torch.rand(b, r, s, generator=gen, device=dev)
        fo, co = outputs(s), outputs(s)
        fz = rf.ray_resample(sigma, z, nz_c, u)
        fz_ref = rf.ray_resample_reference(sigma, z, nz_c, u)
        if not torch.isfinite(fz).all():
            raise AssertionError(f"ray_resample: non-finite output ({label})")
        err_z = (fz - fz_ref).abs().max().item()
        errs = {}   # per fill: max |kernel - plain| of comp, depth, wsum
        for fill in fills:
            fin = rf.ray_finalize(fo, co, fz, z, nz_f, fill_mode=fill)
            fin_ref = rf.ray_finalize_reference(fo, co, fz, z, nz_f,
                                                fill_mode=fill)
            if fin[0].shape != (b, r, rf.filled_channels(c1 - 1, fill)) \
                    or not all(torch.isfinite(t).all() for t in fin):
                raise AssertionError(f"ray_finalize: bad output {label}, "
                                     f"fill {fill}: {fin[0].shape}")
            errs[fill] = [(a - p).abs().max().item()
                          for a, p in zip(fin, fin_ref)]
        del fin, fin_ref

        def torch_resample():
            w = integ.integrate_weights(sigma, z, noise=nz_c, noise_std=1.0)
            return integ.sample_pdf(integ.midpoints(z), (w + 1e-5)[..., 1:-1],
                                    s, u=u)

        kernel_rs = lambda: rf.ray_resample(sigma, z, nz_c, u)
        kernel_fn = lambda: rf.ray_finalize(fo, co, fz, z, nz_f)
        # ms: CUDA events around back-to-back wrapper calls (the host's
        # dispatch included where it is the slower side); device_ms: the
        # kernel's own duration in the profiler; host_us: the wrapper's
        # enqueue per call
        rs = {"ms": time_ms(kernel_rs, 20),
              "device_ms": _device_ms(kernel_rs, "ray_resample_kernel"),
              "host_us": host_us(kernel_rs, 100),
              "plain_ms": time_ms(lambda: rf.ray_resample_reference(
                  sigma, z, nz_c, u), 5),
              "torch_route_ms": time_ms(torch_resample, 5)}
        fn = {"ms": time_ms(kernel_fn, 20),
              "device_ms": _device_ms(kernel_fn, "ray_finalize_kernel"),
              "host_us": host_us(kernel_fn, 100),
              "plain_ms": time_ms(lambda: rf.ray_finalize_reference(
                  fo, co, fz, z, nz_f), 5),
              "torch_route_ms": time_ms(lambda: integ.composite_merged_nosort(
                  fo, co, fz, z, noise=nz_f, noise_std=1.0), 5)}
        (rs["bound_ms"], rs["bound_by"]), (fn["bound_ms"], fn["bound_by"]) = \
            ray_bounds(b, r, s, noisy, c1)
        log(f"[ray] {label} B={b} R={r} S={s}+{s} C={c1} noise={noisy}: "
            f"max|kernel-plain| fine z {err_z:.3e}; " + "; ".join(
                f"fill {fill}: comp {e[0]:.3e}, depth {e[1]:.3e}, "
                f"weights_sum {e[2]:.3e}" for fill, e in errs.items())
            + f" (tol {RAY_TOL})")
        for name, d in (("ray_resample", rs), ("ray_finalize", fn)):
            dev_ms = d["device_ms"]
            device = ("device not measured" if dev_ms is None else
                      f"device {dev_ms:.4f} ms, {d['bound_ms'] / dev_ms:.1%} "
                      "of it the bound")
            log(f"[ray] {label} {name}: kernel {d['ms']:.4f} ms ({device}; "
                f"host {d['host_us']:.1f} us per call), plain "
                f"{d['plain_ms']:.4f} ms, torch route "
                f"{d['torch_route_ms']:.4f} ms, bound {d['bound_ms']:.4f} ms "
                f"({d['bound_by']})")
        err_fin = max(max(e) for e in errs.values())
        if not max(err_z, err_fin) <= RAY_TOL:
            raise AssertionError(f"ray kernels disagree with plain ({label})")
        rows_rs.append({"shape": label, "B": b, "R": r, "S": s, "C": c1,
                        "max_abs_err": err_z, **rs})
        rows_fin.append({"shape": label, "B": b, "R": r, "S": 2 * s,
                         "C": c1, "fills": list(fills),
                         "max_abs_err": err_fin, **fn})
        del fo, co

    # the VJP at the training shape: kernel forward, torch-route backward,
    # against autograd through the torch route itself (noise_std 0.7)
    b, r, s = 6, 1024, 24
    z, _, outputs = ray_inputs(gen, dev, b, r, s)
    fz = torch.sort(z + torch.rand(b, r, s, generator=gen, device=dev)
                    * 0.01, -1).values
    nz = torch.randn(b, r, 2 * s, generator=gen, device=dev)
    fo, co = outputs(s).requires_grad_(), outputs(s).requires_grad_()
    cot = [torch.randn(b, r, N_OUT - 1, generator=gen, device=dev),
           torch.randn(b, r, generator=gen, device=dev),
           torch.randn(b, r, generator=gen, device=dev)]
    dot = lambda outs: sum((o * g).sum() for o, g in zip(outs, cot))
    g_k = torch.autograd.grad(dot(rf.ray_finalize_vjp(
        fo, co, fz, z, nz * 0.7)), (fo, co))
    res = integ.composite_merged_nosort(fo, co, fz, z, noise=nz,
                                        noise_std=0.7)
    g_t = torch.autograd.grad(dot((res.comp, res.depth, res.weights_sum)),
                              (fo, co))
    rel = max(((a - e).abs().max() / e.abs().max()).item()
              for a, e in zip(g_k, g_t))
    log(f"[ray] ray_finalize_vjp at B={b} R={r} S={s}+{s}: cotangents of "
        f"fine_out / coarse_out vs the torch route's autograd, max|diff|/"
        f"max|torch| {rel:.3e} (tol {VJP_TOL})")
    if not rel <= VJP_TOL:
        raise AssertionError("ray_finalize_vjp disagrees with the torch route")

    def summary(rows_):
        return {**rows_[0], "max_abs_err": max(x["max_abs_err"]
                                               for x in rows_),
                "library_ms": None, "shapes": rows_}

    return summary(rows_rs), {**summary(rows_fin), "vjp_max_rel_err": rel}


FOLD_GRID = (32, 96, 96, 96)   # the flagship texture grid (C, D, H, W)


def _one_hot_fold_weight(c, dev):
    """conv3d weight (C, 8C, 2, 2, 2) that folds the table: tap
    (1-dz, 1-dy, 1-dx) of output channel c reads input channel k*C + c,
    k = dz*4 + dy*2 + dx (the one-hot form the TPU kernel used)."""
    wgt = torch.zeros(c, 8 * c, 2, 2, 2, device=dev)
    ch = torch.arange(c, device=dev)
    for k in range(8):
        dz, dy, dx = (k >> 2) & 1, (k >> 1) & 1, k & 1
        wgt[ch, k * c + ch, 1 - dz, 1 - dy, 1 - dx] = 1.0
    return wgt


def phase_fold(dev) -> dict:
    """The fold kernel against its plain version at FOLD_GRID, with an f32
    cotangent (the trainer's) and a bf16 one; with the f32 one also the
    library call that computes the same fold, a conv3d of the table's
    channels-last view with a one-hot weight. Returns the f32 case's times
    and bound, the worst error, both cases under "shapes"."""
    from fenerf_tpu_torch.ops import zexp_fold as zf

    c, d, h, w = FOLD_GRID
    rows = (d + 1) * (h + 1) * (w + 1)
    gen = torch.Generator(device=dev).manual_seed(5)
    wgt = _one_hot_fold_weight(c, dev)

    def library(dt):
        x = dt.view(1, d + 1, h + 1, w + 1, 8 * c).permute(0, 4, 1, 2, 3)
        return torch.nn.functional.conv3d(x, wgt)[0]

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        dt = torch.randn(rows, 8 * c, generator=gen, device=dev).to(dtype)
        out = zf.fold_zexp(dt, FOLD_GRID)
        ref = zf.fold_zexp_reference(dt, FOLD_GRID)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        exact = torch.equal(out, ref)
        ms = time_ms(lambda: zf.fold_zexp(dt, FOLD_GRID), 20)
        plain_ms = time_ms(lambda: zf.fold_zexp_reference(dt, FOLD_GRID), 5)
        # bytes: the eight shifted D x H x W slices of the table the fold
        # reads (each element at most once) and the f32 gradient it writes;
        # ops: seven adds per output
        nbytes = 8 * c * d * h * w * dt.element_size() + c * d * h * w * 4
        bound, by = bound_ms(7 * c * d * h * w, nbytes, PEAK_F32_FLOPS)
        name = str(dtype).replace("torch.", "")
        log(f"[fold] {FOLD_GRID} {name} cotangent: max|kernel-plain|/max|plain|"
            f" {rel:.3e} (tol {FOLD_TOL}), bitwise equal {exact}; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
            f"({by}), {nbytes / ms / 1e6:.0f} GB/s")
        if not rel <= FOLD_TOL:
            raise AssertionError(f"fold kernel disagrees with plain ({name})")
        case = {"dtype": name, "max_abs_err": err, "max_rel_err": rel,
                "bitwise": exact, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": None}
        if dtype == torch.float32:   # a bf16 conv3d would write bf16
            lib = library(dt)
            lib_rel = ((lib - ref).abs().max() / ref.abs().max()).item()
            case["library_ms"] = time_ms(lambda: library(dt), 5)
            log(f"[fold] library call (conv3d, one-hot weight, f32): "
                f"max|conv3d-plain|/max|plain| {lib_rel:.3e} (tol "
                f"{LIBRARY_FOLD_TOL}); {case['library_ms']:.4f} ms")
            if not lib_rel <= LIBRARY_FOLD_TOL:
                raise AssertionError("the conv3d fold disagrees with plain")
            del lib
        cases.append(case)
        del dt, out, ref
    return {**cases[0], "max_abs_err": max(x["max_abs_err"] for x in cases),
            "shapes": cases}


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=600) as r:
        if r.status != 200:
            raise AssertionError(f"{url}: HTTP {r.status}")
        return r.read()


def _serve(render_np, meta):
    from fenerf_tpu_torch.apps.serve import make_server

    srv = make_server(render_np, meta, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def write_checkpoint(dev, tmp, sigma_bias=SIGMA_BIAS, head_gain=1.0,
                     name="generator.npz") -> str:
    """The flagship's random weights (seed 1) as a generator .npz, the
    sigma head's bias raised by sigma_bias, the colour and label heads'
    last weights scaled by head_gain."""
    from fenerf_tpu_torch.apps.common import save_generator

    _, params, _ = _flagship_params(dev, seed=1, sigma_bias=sigma_bias)
    for head in (params["color_head"], params["label_head"][-1]):
        head["w"] = head["w"] * head_gain
    ckpt = os.path.join(tmp, name)
    t0 = time.perf_counter()
    save_generator(ckpt, params, params, params, FLAGSHIP, step=0)
    log(f"[serve] wrote full-width checkpoint, sigma bias {sigma_bias:+g}, "
        f"head gain {head_gain:g} "
        f"({os.path.getsize(ckpt) / 2**20:.0f} MiB) in "
        f"{time.perf_counter() - t0:.1f} s")
    return ckpt


def phase_serve(ckpt, ray: str) -> dict:
    """The serving path with FENERF_RAY_KERNELS=ray. Returns the launches
    of each kernel over the whole phase, the renders, and ms/request."""
    from fenerf_tpu_torch.apps.serve import build_renderer

    rays = SERVE["image_size"] ** 2
    tag = f"[serve ray={ray}]"
    with ray_kernels(ray):
        # --- the main path: counts from zero ---
        zero_counts()
        render_np, meta = build_renderer(ckpt, device="cuda", **SERVE)
        if meta["backend"] != "kernel":
            raise AssertionError(f"serving backend is {meta['backend']}")
        want = "kernels" if ray == "auto" else "torch"
        log(f"{tag} ray route: {meta['ray_route']} ({meta['ray_route_why']})")
        if meta["ray_route"] != want:
            raise AssertionError(f"ray route {meta['ray_route']}, not {want}")
        t0 = time.perf_counter()
        render_np(0, 0.0, 0.0, 0.7)
        log(f"{tag} batch-1 warm-up render {time.perf_counter() - t0:.2f} s")
        srv, base = _serve(render_np, meta)
        try:
            assert json.loads(_get(base + "/healthz"))["ok"] is True
            for kind in ("rgb", "seg", "depth"):
                body = _get(f"{base}/render?seed=3&yaw=0.2&psi=0.5&kind={kind}")
                # the PNG's IHDR: width and height of the render
                if body[:8] != PNG_MAGIC or struct.unpack(
                        ">II", body[16:24]) != (SERVE["image_size"],) * 2:
                    raise AssertionError(f"kind={kind}: not a "
                                         f"{SERVE['image_size']}^2 PNG")
            a = _get(f"{base}/render?seed=5&yaw=-0.1&pitch=0.05")
            b = _get(f"{base}/render?seed=5&yaw=-0.1&pitch=0.05")
            assert a == b, "same request gave different bytes"
            n_req = 5
            t0 = time.perf_counter()
            for i in range(n_req):
                assert _get(f"{base}/render?seed={i}&yaw={0.1 * i}")[:8] \
                    == PNG_MAGIC
            dt = (time.perf_counter() - t0) / n_req
            log(f"{tag} batch 1: {n_req} sequential rgb requests, "
                f"{dt * 1e3:.1f} ms/request, {rays / dt:.0f} rays/s "
                f"({SERVE['image_size']}^2, "
                f"{SERVE['num_steps']}x{SERVE['ray_step_multiplier']} steps)")
        finally:
            srv.shutdown()
            srv.server_close()

        render_b, meta_b = build_renderer(ckpt, device="cuda", batch=4,
                                          batch_wait_ms=50.0, **SERVE)
        render_b(0, 0.0, 0.0, 0.7)  # warm-up
        srv, base = _serve(render_b, meta_b)
        try:
            def get(i):
                return _get(f"{base}/render?seed={i}&yaw={0.1 * i}"
                            f"&pitch={0.02 * i}&psi={0.5 + 0.1 * (i % 3)}")

            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=6) as ex:
                bodies = list(ex.map(get, range(6)))
            dt4 = time.perf_counter() - t0
            assert all(x[:8] == PNG_MAGIC for x in bodies)
            assert len(set(bodies)) > 1, "batched rows were not routed"
            log(f"{tag} batch 4: 6 concurrent requests in {dt4 * 1e3:.1f} ms, "
                f"{dt4 / 6 * 1e3:.1f} ms/request, {6 * rays / dt4:.0f} rays/s")
        finally:
            srv.shutdown()
            srv.server_close()
        launches, plain = read_counts()

    # a render is 4 ray blocks of 4096 rays, two field evaluations each
    blocks = SERVE["image_size"] ** 2 // SERVE["ray_chunk"]
    renders = launches["film_mlp"] // (2 * blocks)
    ray_per_render = blocks if ray == "auto" else 0
    log(f"{tag} launches {launches} over {renders} renders, plain-version "
        f"calls {plain}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if (renders <= 0 or launches["film_mlp"] != 2 * blocks * renders
            or launches["ray_resample"] != ray_per_render * renders
            or launches["ray_finalize"] != ray_per_render * renders
            or plain != 0):
        raise AssertionError(f"serving (ray={ray}) did not run through its "
                             "kernels alone")
    return {"launches": launches, "renders": renders,
            "ms_per_request": dt * 1e3}


def phase_render(dev):
    """One whole 128^2 render at the serve defaults: the field kernel
    against its plain version; the ray kernels (FENERF_RAY_KERNELS=auto)
    against the torch route; ray-chunked against whole-image on both ray
    routes."""
    from fenerf_tpu_torch.models import generator as gen
    from fenerf_tpu_torch.nn import fields
    from fenerf_tpu_torch.ops import film_mlp

    cfg, params, g = _flagship_params(dev, seed=2)
    params = film_mlp.with_pack(
        fields.with_grid_table(params, cfg, torch.bfloat16), cfg)
    zg = torch.randn(1, cfg.z_geo_dim, generator=g, device=dev)
    za = torch.randn(1, cfg.z_app_dim, generator=g, device=dev)
    avg = fields.avg_film(params, cfg,
                          torch.Generator(device=dev).manual_seed(42))
    fg, fa = fields.field_film(params, cfg, zg, za)
    fg = fields.truncate_film(fg, avg[0], 0.7)
    fa = fields.truncate_film(fa, avg[1], 0.7)
    steps = SERVE["num_steps"] * SERVE["ray_step_multiplier"]
    camera = (math.pi / 2, math.pi / 2 + 0.2, SERVE["fov"])

    def render(chunk, plain=False, ray="never"):
        rcfg = gen.RenderConfig(
            img_size=SERVE["image_size"], num_steps=steps, fov=SERVE["fov"],
            fill_mode=SERVE["fill_mode"], ray_chunk=chunk,
            compute_dtype="bfloat16", backend="kernel")
        field_fn = gen._film_field_fn(params, cfg, rcfg, fg, fa)
        if plain:   # the same fused field through its plain version
            pack = params[film_mlp.PACK_KEY]

            def field_fn(pts, drs):
                warped = pts * (2.0 / cfg.box_side)
                gf = fields._grid_feats(params, warped, torch.bfloat16)
                return film_mlp.film_mlp_reference(pack, warped, drs, gf,
                                                   fg, fa)
        with ray_kernels(ray):
            out = gen.render_core(
                field_fn, cfg.output_dim, rcfg, 1, camera=camera,
                generator=torch.Generator(device=dev).manual_seed(0),
                device=dev)
        torch.cuda.synchronize()
        return out

    kern = render(SERVE["ray_chunk"])
    plain = render(SERVE["ray_chunk"], plain=True)
    whole = render(0)
    zero_counts()
    ray = render(SERVE["ray_chunk"], ray="auto")
    launches, n_plain = read_counts()
    ray_whole = render(0, ray="auto")
    px = kern["pixels"]
    for out in (kern, ray):
        if not (torch.isfinite(out["pixels"]).all()
                and out["pixels"].shape == (1, cfg.n_labels + 1 + 3,
                                            SERVE["image_size"],
                                            SERVE["image_size"])):
            raise AssertionError(f"bad render {tuple(out['pixels'].shape)}")
    err = (px - plain["pixels"]).abs().max().item()
    chunk_err = (px - whole["pixels"]).abs().max().item()
    log(f"[render] mean opacity {kern['opacity'].mean().item():.4f}; "
        f"max|kernel-plain| pixel {err:.3e} (tol {RENDER_TOL}); ray_chunk "
        f"{SERVE['ray_chunk']} vs whole image max|diff| {chunk_err:.3e} "
        f"(bit-exact: {torch.equal(px, whole['pixels'])})")
    ray_err = (ray["pixels"] - px).abs().max().item()
    log(f"[render] ray kernels: mean opacity "
        f"{ray['opacity'].mean().item():.4f}; max|ray kernels - torch route| "
        f"pixel {ray_err:.3e} (tol {RENDER_TOL}), depth "
        f"{(ray['depth'] - kern['depth']).abs().max().item():.3e}, opacity "
        f"{(ray['opacity'] - kern['opacity']).abs().max().item():.3e}; "
        f"ray_chunk vs whole image bit-exact: "
        f"{torch.equal(ray['pixels'], ray_whole['pixels'])}; launches of one "
        f"render {launches}, plain-version calls {n_plain}")
    if not err <= RENDER_TOL:
        raise AssertionError(f"kernel render disagrees with plain: {err}")
    if not ray_err <= RENDER_TOL:
        raise AssertionError(f"ray-kernel render disagrees with the torch "
                             f"route: {ray_err}")
    if not (torch.equal(px, whole["pixels"])
            and torch.equal(ray["pixels"], ray_whole["pixels"])):
        raise AssertionError("ray-chunked render differs from whole image")
    blocks = SERVE["image_size"] ** 2 // SERVE["ray_chunk"]
    if (launches["ray_resample"], launches["ray_finalize"], n_plain) != (
            blocks, blocks, 0):
        raise AssertionError(f"one render: {launches}, {n_plain} plain")


# G's gradient, kernel route against the torch route at bf16: the JAX
# package's own criterion (tests/test_film_mlp_kernel.py:159-185)
GRAD_COS, GRAD_NORM = 0.999, 0.02
TEXTURE = "CelebA_double_semantic_texture_embedding_256_dim_96"
TRAIN_STEPS = 6     # the first is warm-up; ms/step is the median of the rest


def _macs_per_point_unfolded(cfg) -> int:
    """Multiply-adds per point of the unfolded field (the backward's
    forward): every linear of ops/film_mlp_grad.py::mlp_layers."""
    h, g = cfg.hidden_dim, cfg.grid_channels
    return (3 * h + (cfg.trunk_layers - 1) * h * h
            + (3 + g + h) * h + (cfg.color_layers - 1) * h * h
            + h
            + cfg.label_hidden_layers * h * h + h * cfg.n_labels
            + h * cfg.rgb_dim)


def _bwd_case(cfg, params, pack, gen, b, n, dev, tag="[backward]") -> dict:
    """The backward kernels against their plain version at (B, N): per
    output group by ops/film_mlp_grad.py::bwd_agreement, bitwise equal run
    to run, times beside the bound and the bf16 products through
    torch.matmul. Raises on disagreement; returns the shape's numbers."""
    from fenerf_tpu_torch.nn import fields
    from fenerf_tpu_torch.ops import film_mlp_grad as gops

    pts = (torch.rand(b, n, 3, generator=gen, device=dev) - 0.5) * 0.24
    dirs = torch.nn.functional.normalize(
        torch.randn(b, n, 3, generator=gen, device=dev), dim=-1)
    zg = torch.randn(b, cfg.z_geo_dim, generator=gen, device=dev)
    za = torch.randn(b, cfg.z_app_dim, generator=gen, device=dev)
    fg, fa = fields.field_film(params, cfg, zg, za)
    warped = pts * (2.0 / cfg.box_side)
    gf = fields._grid_feats(params, warped, torch.bfloat16)
    g_out = torch.randn(b, n, cfg.output_dim, generator=gen, device=dev)
    args = (pack, warped, dirs, gf, fg, fa, g_out)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = gops.film_mlp_bwd(*args)
    again = gops.film_mlp_bwd(*args)
    # timed before the plain version fills the allocator's cache
    ms = time_ms(lambda: gops.film_mlp_bwd(*args), iters=5)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    # the plain version at 1.2M rows holds ~42 GiB of per-row state
    torch.cuda.empty_cache()
    ref = gops.film_mlp_bwd_reference(*args)
    torch.cuda.synchronize()
    groups = gops.bwd_agreement(out, ref)
    # no atomics: the same bits from run to run, in every output
    bitwise = all(torch.equal(x, y) for xs, ys in zip(out[0], again[0])
                  for x, y in zip(xs, ys)) and all(
        (x is None and y is None) or torch.equal(x, y)
        for x, y in zip(out[1:], again[1:]))
    del again
    worst_rel = max(groups, key=lambda r: r[1])
    worst_cos = min(groups, key=lambda r: r[2])
    rows = b * n
    plain_ms = time_ms(lambda: gops.film_mlp_bwd_reference(*args),
                       iters=2, warmup=1)
    flops = 6 * _macs_per_point_unfolded(cfg) * rows
    nbytes = (rows * (4 * 3 * 2 + 2 * cfg.grid_channels
                      + 4 * cfg.output_dim               # inputs
                      + 4 * 3 * 2 + 4 * cfg.grid_channels)  # outputs
              + pack.weights.numel() * 2
              + 4 * sum(w.numel() + bb.numel() for w, bb in out[0]))
    bound, by = bound_ms(flops, nbytes)
    context = _products_ms(_bwd_products(pack, rows), dev, iters=3)
    log(f"{tag} B={b} N={n} rows={rows} worst max|diff|/max|plain| "
        f"{worst_rel[1]:.3e} ({worst_rel[0]}), worst cosine "
        f"{worst_cos[2]:.7f} ({worst_cos[0]}) (limits {gops.BWD_TOL}, "
        f"per-point groups {gops.BWD_TOL_PER_POINT}, cos > "
        f"{gops.BWD_COS}); bitwise equal run to run {bitwise}; kernel "
        f"{ms:.3f} ms plain {plain_ms:.3f} ms, peak device memory of the "
        f"kernel's calls {peak_gib:.2f} GiB, "
        f"{rows / ms / 1e3:.2f} Mpts/s, {flops / ms / 1e9:.1f} TFLOP/s "
        f"({bound / ms:.1%} of the bound), bound {bound:.3f} ms ({by}); "
        f"context: the same {len(_bwd_products(pack, rows))} bf16 "
        f"products (recompute, dX, dW) through torch.matmul "
        f"{context:.3f} ms")
    log(f"{tag} groups " + " ".join(
        f"{nm}:{rel:.2e}/{cos:.6f}" for nm, rel, cos, _ in groups))
    bad = [r for r in groups if not r[3]]
    if bad:
        raise AssertionError(f"backward kernel disagrees: {bad}")
    if not bitwise:
        raise AssertionError("backward kernel differs from run to run")
    return {"B": b, "N": n, "max_abs_err": max(
                (x - y).abs().max().item() for xs, ys in zip(out[0], ref[0])
                for x, y in zip(xs, ys)),
            "max_rel_err": worst_rel[1], "min_cos": worst_cos[2], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "context_ms": context, "bitwise": bitwise, "peak_gib": peak_gib}


def phase_backward(dev) -> dict:
    """The backward kernels against their plain version per output group,
    by the criterion ops/film_mlp_grad.py::bwd_agreement states (the one
    the card tests use), at the G shape and a ragged one. Returns the G
    shape's times and bound, the worst errors over both shapes, and each
    shape's numbers under "shapes"."""
    from fenerf_tpu_torch.nn import fields
    from fenerf_tpu_torch.ops import film_mlp_grad as gops

    cfg, params, gen = _flagship_params(dev, seed=3)
    params = fields.with_grid_table(params, cfg, torch.bfloat16)
    pack = gops.pack_bwd(params, cfg)
    # the G shape, a ragged one, one with more tiles than SMs and
    # N % 128 != 0, and the 64^2 stage's G microbatch (1,179,648 rows)
    shapes = [_bwd_case(cfg, params, pack, gen, b, n, dev)
              for b, n in ((6, 32 * 32 * 24), (2, 1000), (2, 20000),
                           (12, 64 * 64 * 24))]
    return {**shapes[0], **{k: max(s[k] for s in shapes) for k in
                            ("max_abs_err", "max_rel_err")},
            "min_cos": min(s["min_cos"] for s in shapes), "library_ms": None,
            "shapes": shapes}


def _synthetic_reals(gen, b, size, dev):
    """Smooth random images in [-1, 1] (bilinear upsampling of 4x4 noise)
    and one-hot 18-class label maps scaled to [-1, 1]."""
    up = lambda t: torch.nn.functional.interpolate(
        t, size=(size, size), mode="bilinear", align_corners=False)
    imgs = up(torch.rand(b, 3, 4, 4, generator=gen, device=dev) * 2 - 1)
    lab = up(torch.rand(b, 18, 8, 8, generator=gen, device=dev)).argmax(1)
    labels = torch.nn.functional.one_hot(lab, 18).permute(0, 3, 1, 2)
    return imgs.clamp(-1, 1), labels.float() * 2 - 1


def phase_train(dev, ray_on: bool):
    """TRAIN_STEPS steps of the flagship's stage 0 through the kernels,
    with the ray kernels off or on. Returns ({launches by kernel,
    ms/step}, the state after the steps)."""
    from fenerf_tpu_torch.train import loop
    from fenerf_tpu_torch.train.curriculum import CURRICULA

    cur = CURRICULA[TEXTURE]
    meta = cur.at_step(0)
    state = loop.init_train_state(meta, seed=0, device="cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    as_t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    tag = f"[train {'ray kernels' if ray_on else 'torch ray route'}]"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    times = []
    with ray_kernels("auto" if ray_on else "never"):
        # --- the main path: counts from zero ---
        zero_counts()
        for step in range(TRAIN_STEPS):
            imgs, labels = _synthetic_reals(gen, meta.batch_size,
                                            meta.img_size, dev)
            scal = loop.StepScalars(alpha=as_t(cur.alpha(step)),
                                    noise_std=as_t(meta.nerf_noise(step)),
                                    topk_frac=as_t(meta.topk_fraction(step)))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = loop.train_step(state, imgs, labels, scal, meta,
                                       generator=gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses = {k: float(m[k]) for k in ("d_img_loss", "d_seg_loss",
                                               "g_loss", "fake_opacity")}
            log(f"{tag} step {step}: " + " ".join(
                f"{k} {v:.5f}" for k, v in losses.items())
                + f" ({times[-1] * 1e3:.1f} ms)")
            if not all(math.isfinite(v) for v in losses.values()):
                raise AssertionError(f"non-finite loss at step {step}")
        counts, plain = read_counts()
    ms = statistics.median(times[1:]) * 1e3
    # renders per step: D_img, D_seg and G, one per microbatch, each one
    # ray block (no ray_chunk in training) and two field evaluations
    renders = 3 * meta.batch_split
    on = int(ray_on)
    per_step = {"film_mlp": 2 * renders, "film_mlp_bwd": 2 * meta.batch_split,
                "ray_resample": on * renders, "ray_finalize": on * renders,
                "fold_zexp": 1}
    log(f"{tag} {TEXTURE} stage 0 (bs {meta.batch_size}, split "
        f"{meta.batch_split}, {meta.img_size}^2, {meta.num_steps}+"
        f"{meta.num_steps} steps): {ms:.1f} ms/step (median of steps 2-"
        f"{TRAIN_STEPS}; range {min(times[1:]) * 1e3:.1f}-"
        f"{max(times[1:]) * 1e3:.1f}), {meta.batch_size / ms * 1e3:.2f} "
        f"images/s; launches {counts} (per step "
        f"{ {k: v / TRAIN_STEPS for k, v in counts.items()} }), "
        f"plain-version calls {plain}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if counts != {k: per_step.get(k, 0) * TRAIN_STEPS for k in counts} \
            or plain != 0:
        raise AssertionError(f"training did not run through the kernels "
                             f"alone: expected {per_step} per step")
    return {"launches": counts, "ms_per_step": ms}, state


# the trainer's entry point (fenerf_tpu_torch.apps.train) on a synthetic
# CelebAMask-HQ tree: the committed fixture JPEGs (1024^2, 4:2:0) in turn,
# 48 pairs (the 64^2 stage's batch), 512^2 label PNGs
TRAIN_CLI_PAIRS = 48
TRAIN_CLI = ["--curriculum", TEXTURE, "--log_every", "1", "--device", "cuda"]
STAGE0 = ["--total_steps", "6", "--model_save_interval", "3",
          "--sample_interval", "3", "--eval_freq", "6", "--num_eval_imgs",
          "64", "--num_real_imgs", "64"]
RESUMED = ["--total_steps", "8", "--model_save_interval", "3",
           "--sample_interval", "3", "--eval_freq", "6"]
STAGE64 = ["--set_step", "20000", "--total_steps", "20004",
           "--model_save_interval", "4", "--sample_interval", "4",
           "--eval_freq", "0"]
# stage 0 with the G phase's gradients on half of its rays and DiffAugment
# on the image critic's inputs
GRAD_RAYS = 0.5
AUGMENTED = ["--total_steps", "2", "--model_save_interval", "0",
             "--sample_interval", "0", "--eval_freq", "0", "--grad_rays",
             str(GRAD_RAYS), "--stage_overrides",
             json.dumps({"diff_augment_policy": "color,translation,cutout"})]
# the grad_rays render's pixels against the grad_rays = 1 render's on the
# same draws: the same rows through the same kernels, in another grouping
GRAD_RAYS_TOL = 1e-6
# a sample or eval render: 128^2 in ray blocks of 4096, a field evaluation
# before and after the resample per block; eval renders in batches of 16
EVAL_BLOCKS = 128 * 128 // 4096
# Inception features, card against the port on the CPU, relative to each
# row's largest feature: f32 convolutions with TF32 off, another order
INCEPTION_TOL = 1e-4
# the real dump scored against itself
SELF_FID_TOL = 1e-3


class _Tee:
    """stdout to the terminal and a buffer (the CLI's [eval-t] lines)."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, text):
        self.lines.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _expected_launches(steps, split, samples, eval_images, ray_on,
                       grad_rays=False):
    """Launches of a CLI run: per step 2 field evaluations in each of the
    3 x split renders (D_img, D_seg and G microbatches), the backward twice
    per G microbatch, one fold; 5 renders per sample event and one per 16
    eval images, EVAL_BLOCKS ray blocks each; the ray kernels once per
    block with the switch on. With grad_rays < 1 each G render shades its
    rays in two blocks, the subset (forward and backward kernels) and the
    rest (forward kernel only)."""
    renders = samples * 5 + math.ceil(eval_images / 16)
    blocks = (steps * 3 * split + renders * EVAL_BLOCKS
              + grad_rays * steps * split)
    return {"film_mlp": 2 * blocks, "film_mlp_bwd": 2 * split * steps,
            "fold_zexp": steps, "ray_resample": ray_on * blocks,
            "ray_finalize": ray_on * blocks}


def _grad_rays_render(state, meta, dev) -> float:
    """A G microbatch's render on the kernels at the CLI's grad_rays, with
    the trained parameters: the subset through kernel_train, the rest under
    no_grad on the forward kernel; returns its pixels' largest distance
    from the grad_rays = 1 render on the same draws."""
    import dataclasses

    from fenerf_tpu_torch.compat.jax_bridge import tree_leaves
    from fenerf_tpu_torch.models import generator as gen

    fcfg = meta.field_config()
    rcfg = dataclasses.replace(meta.render_config(), backend="kernel_train",
                               grad_rays=GRAD_RAYS)
    b = meta.batch_size // meta.batch_split
    g = torch.Generator(device=dev).manual_seed(11)
    zg = torch.randn(b, fcfg.z_geo_dim, generator=g, device=dev)
    za = torch.randn(b, fcfg.z_app_dim, generator=g, device=dev)
    noise = meta.nerf_noise(0)
    draws = gen.draw_render(g, b, rcfg, noise, rcfg.sample_dist, dev)
    params = state.g_params
    for t in tree_leaves(params):
        t.requires_grad_(True)
    try:
        out = gen.render_from_z(params, fcfg, rcfg, zg, za, noise,
                                draws=draws)
        n_grad = int(out["grad_ray_mask"].sum())
        if not 0 < n_grad < rcfg.n_rays:
            raise AssertionError(f"grad_rays {GRAD_RAYS}: {n_grad} of "
                                 f"{rcfg.n_rays} rays carry gradients")
        with torch.no_grad():
            full = gen.render_from_z(
                params, fcfg, dataclasses.replace(rcfg, grad_rays=1.0), zg,
                za, noise, draws=draws)
    finally:
        for t in tree_leaves(params):
            t.requires_grad_(False)
    return float((out["pixels"].detach() - full["pixels"]).abs().max())


def phase_train_cli(dev) -> dict:
    """The trainer's CLI in this process: stage 0 with samples, checkpoints
    and the FID protocol on stand-in InceptionV3 weights; --load_dir on the
    same directory for 2 more steps; the 64^2 stage by --set_step with the
    ray kernels on; stage 0 again with --grad_rays and DiffAugment. Checks
    the card-built decoder against the fixture digests, finite losses, the
    launches of every kernel per run (no plain version), the resume step,
    the grad_rays render's pixels, a finite FID, the real dump's FID
    against itself and Inception features against the CPU. Returns the
    launches of the four runs and the numbers it printed."""
    from fenerf_tpu_torch.apps import train as train_cli
    from fenerf_tpu_torch.data import native_loader, synthetic
    from fenerf_tpu_torch.eval import fid as fidlib
    from fenerf_tpu_torch.nn import inception
    from fenerf_tpu_torch.train.curriculum import CURRICULA

    digests = synthetic.fixture_digests()
    fixtures = [str(synthetic.FIXTURES / n) for n in sorted(digests)]
    t0 = time.perf_counter()
    for name, path in zip(sorted(digests), fixtures):
        got = hashlib.sha256(
            native_loader.read_image(path, "RGB").tobytes()).hexdigest()
        if got != digests[name]:
            raise AssertionError(f"the decoder built here decodes {name} "
                                 f"unlike PIL (sha256 {got})")
    log(f"[train cli] the codec built on this machine decodes all "
        f"{len(fixtures)} fixture JPEGs (1024^2, 4:2:0) to PIL's pixels "
        f"(decoded.sha256), {(time.perf_counter() - t0) * 1e3:.1f} ms")

    cur = CURRICULA[TEXTURE]
    results = {"launches": {}}
    old_weights = os.environ.get(fidlib.WEIGHTS_ENV)
    with tempfile.TemporaryDirectory() as tmp:
        root = synthetic.write_celebamask_tree(
            os.path.join(tmp, "celebamask"), fixtures, count=TRAIN_CLI_PAIRS)
        weights = os.path.join(tmp, "inception.npz")
        inception.export_npz(inception.init_inception(
            torch.Generator().manual_seed(0)), weights)
        os.environ[fidlib.WEIGHTS_ENV] = weights
        out0, out64, out_aug = (os.path.join(tmp, d)
                                for d in ("run", "run64", "run_aug"))
        runs = (("stage 0", out0, STAGE0, "never", 6, 3, 2, 64),
                ("resumed", out0, RESUMED + ["--load_dir", out0], "never",
                 2, 3, 0, 0),
                ("64^2", out64, STAGE64, "auto", 4, 4, 1, 0),
                ("grad_rays", out_aug, AUGMENTED, "never", 2, 0, 0, 0))
        try:
            for tag, out, extra, ray, steps, every, samples, n_eval in runs:
                tee = _Tee(sys.stdout)
                zero_counts()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                with ray_kernels(ray), contextlib.redirect_stdout(tee):
                    state = train_cli.main(
                        TRAIN_CLI + ["--data_root", root, "--output_dir",
                                     out] + extra)
                seconds = time.perf_counter() - t0
                counts, plain = read_counts()
                meta = cur.at_step(20000 if tag == "64^2" else 0)
                want = _expected_launches(steps, meta.batch_split, samples,
                                          n_eval, int(ray == "auto"),
                                          grad_rays=tag == "grad_rays")
                results["launches"][tag] = counts
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                text = "".join(tee.lines)
                log(f"[train cli] {tag}: {seconds:.1f} s, launches {counts}, "
                    f"plain-version calls {plain}, peak device memory "
                    f"{peak:.2f} GiB")
                if counts != {k: want.get(k, 0) for k in counts} or plain:
                    raise AssertionError(
                        f"train cli {tag}: launches {counts}, plain {plain}; "
                        f"expected {want}")
                results[tag] = {"seconds": seconds, "peak_gib": peak,
                                "stdout": text}
            logs = {}
            for tag, out in (("stage 0", out0), ("64^2", out64),
                             ("grad_rays", out_aug)):
                with open(os.path.join(out, "metrics.jsonl")) as f:
                    logs[tag] = [json.loads(x) for x in f]
            steps0 = [x["step"] for x in logs["stage 0"]]
            if steps0 != list(range(8)) or "at step 6" not in \
                    results["resumed"]["stdout"]:
                raise AssertionError(f"the resumed run did not start at step "
                                     f"6: logged steps {steps0}")
            if [x["step"] for x in logs["64^2"]] != list(range(20000, 20004)):
                raise AssertionError("the 64^2 run logged the wrong steps")
            if [x["step"] for x in logs["grad_rays"]] != [0, 1]:
                raise AssertionError("the grad_rays run logged the wrong "
                                     "steps")
            losses = ("d_img_loss", "d_seg_loss", "g_loss")
            for tag, lines in logs.items():
                for x in lines:
                    if not all(math.isfinite(x[k]) for k in losses):
                        raise AssertionError(f"{tag}: non-finite loss at "
                                             f"step {x['step']}: {x}")
                    log(f"[train cli] {tag} step {x['step']}: " + " ".join(
                        f"{k} {x[k]:.4f}" for k in losses)
                        + f", step {x['step_ms']:.1f} ms, loader "
                        f"{x['loader_ms']:.1f} ms per batch, waited "
                        f"{x['data_wait_ms']:.1f} ms")
            # `state` is the grad_rays run's, the last; after the run, so
            # these launches stay out of its counts
            err = _grad_rays_render(state, cur.at_step(0), dev)
            log(f"[train cli] grad_rays {GRAD_RAYS} render of a G microbatch"
                f" on the kernels against grad_rays 1 on the same draws: "
                f"max|diff| {err:.3e} (tol {GRAD_RAYS_TOL})")
            if not err <= GRAD_RAYS_TOL:
                raise AssertionError("the grad_rays render's pixels differ")
            with open(os.path.join(out0, "fid.txt")) as f:
                fid = float(f.read().strip().split(":")[-1])
            if not math.isfinite(fid):
                raise AssertionError(f"fid.txt holds {fid}")
            # the real dump against itself, the protocol's two parts timed
            # apart: Inception on the card, the Frechet distance's sqrtm of
            # 2048^2 on the host
            real = os.path.join(out0, "evaluation", "real")
            feats = fidlib.inception_features(device="cuda")
            imgs = fidlib._load_images(real)
            feats(imgs[:4])      # the first call builds cuDNN's plans
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f_real = np.asarray(feats(imgs))
            inception_ms = (time.perf_counter() - t0) * 1e3 / len(imgs)
            t0 = time.perf_counter()
            self_fid = fidlib.fid_from_features(f_real, f_real)
            frechet_s = time.perf_counter() - t0
            f_card = f_real[:4]
            f_cpu = fidlib.inception_features(device="cpu")(imgs[:4])
            rel = float((np.abs(f_card - f_cpu).max(axis=1)
                         / np.abs(f_cpu).max(axis=1)).max())
            log(f"[train cli] FID at step 6 (stand-in weights) {fid:.4f}; "
                f"the real dump against itself {self_fid:.3e} (tol "
                f"{SELF_FID_TOL}); Inception features, card vs CPU, 4 "
                f"images: max|diff|/max|cpu| per row {rel:.3e} (tol "
                f"{INCEPTION_TOL})")
            if not abs(self_fid) < SELF_FID_TOL or not rel <= INCEPTION_TOL:
                raise AssertionError("FID protocol check failed")
        finally:
            if old_weights is None:
                os.environ.pop(fidlib.WEIGHTS_ENV, None)
            else:
                os.environ[fidlib.WEIGHTS_ENV] = old_weights

    def eval_t(key):
        m = re.search(rf"\[eval-t\] {key}=([0-9.]+) images=(\d+)",
                      results["stage 0"]["stdout"])
        return float(m.group(1)), int(m.group(2))

    render_s, n_render = eval_t("output_images_s")
    score_s, n_scored = eval_t("calculate_fid_s")
    workers = max(1, min((os.cpu_count() or 2) - 1, 8))
    # each run's first step waits for the loader's first batch
    firsts = (0, 6, 20000)
    for size, tag, bs in ((32, "stage 0", cur.at_step(0).batch_size),
                          (64, "64^2", cur.at_step(20000).batch_size),
                          (32, "grad_rays", cur.at_step(0).batch_size)):
        lines = [x for x in logs[tag] if x["step"] not in firsts]
        ms = statistics.median(x["step_ms"] for x in lines)
        loader = statistics.median(x["loader_ms"] for x in logs[tag])
        key = f"{size}" if tag != "grad_rays" else "32_grad_rays"
        results[f"ms_per_step_{key}"] = ms
        results[f"imgs_per_s_{key}"] = bs / ms * 1e3
        results[f"loader_ms_{key}"] = loader
        log(f"[train cli] {tag}, {size}^2 (bs {bs}): {ms:.1f} ms/step (the "
            f"CLI's step window, its wait for data included; median of "
            f"{len(lines)} steps, range "
            f"{min(x['step_ms'] for x in lines):.1f}-"
            f"{max(x['step_ms'] for x in lines):.1f}), {bs / ms * 1e3:.2f} "
            f"images/s; the loader's host time {loader:.1f} ms per batch "
            f"(median) in one of {workers} worker processes, "
            f"{loader / workers:.1f} ms per batch across them")
    results["inception_ms_per_image"] = inception_ms
    results["frechet_s"] = frechet_s
    log(f"[train cli] FID block: {render_s / n_render * 1e3:.2f} ms per "
        f"rendered image ({n_render} at 128^2); Inception "
        f"{inception_ms:.2f} ms per image ({len(imgs)} at 128^2, one batch);"
        f" the Frechet distance (host sqrtm of 2048^2) {frechet_s:.2f} s; "
        f"the CLI's calculate_fid {score_s:.2f} s for {n_scored} images; "
        f"peak device memory {results['stage 0']['peak_gib']:.2f} / "
        f"{results['64^2']['peak_gib']:.2f} / "
        f"{results['grad_rays']['peak_gib']:.2f} GiB (stage 0 / 64^2 / "
        f"grad_rays)")
    for tag in ("stage 0", "resumed", "64^2", "grad_rays"):
        del results[tag]["stdout"]
    return results


def _grad_compare(x, y):
    """Worst per-group cosine and relative norm difference (against y) of
    two gradient leaf lists, skipping groups whose two norms are both below
    1e-8; and the number of groups compared."""
    worst_cos, worst_norm, n_cmp = 1.0, 0.0, 0
    for a, b in zip(x, y):
        a, b = a.double().flatten(), b.double().flatten()
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            return float("nan"), float("nan"), n_cmp
        na, nb = a.norm().item(), b.norm().item()
        if na < 1e-8 and nb < 1e-8:
            continue
        n_cmp += 1
        worst_cos = min(worst_cos, (a @ b).item() / max(na * nb, 1e-30))
        worst_norm = max(worst_norm, abs(na - nb) / max(nb, 1e-12))
    return worst_cos, worst_norm, n_cmp


def _g_grads(state, meta, backend, compute_dtype, loss_fn):
    """G's parameter gradients (texture grid folded from the bf16 table's
    cotangent) of loss_fn(params, fcfg, rcfg) through one route."""
    import dataclasses

    from fenerf_tpu_torch.compat.jax_bridge import tree_leaves
    from fenerf_tpu_torch.core.grid_sample import (build_zexp_table,
                                                   zexp_table_adjoint)
    from fenerf_tpu_torch.nn import fields
    from fenerf_tpu_torch.train import loop

    with torch.no_grad():
        table = build_zexp_table(state.g_params["grid"], torch.bfloat16)
    rcfg = dataclasses.replace(meta.render_config(), backend=backend,
                               compute_dtype=compute_dtype)
    rp = loop._leaf_copy({**state.g_params, fields.GRID_TABLE_KEY: table})
    loss = loss_fn(rp, meta.field_config(), rcfg)
    g = loop._grads(loss, rp)
    g["grid"] = g["grid"] + zexp_table_adjoint(
        g.pop(fields.GRID_TABLE_KEY), tuple(state.g_params["grid"].shape))
    return loss.item(), tree_leaves(g)


def phase_grad(dev, meta, trained):
    """G's gradient through the kernels against the torch route at bf16.

    Held to the criterion: the field's vector-Jacobian product at the G
    shape (one microbatch, B=6, N=32^2 x 24): apply_field through
    'kernel_train' (FilmMlpTrainable: the forward and backward kernels)
    and through the torch route, the same points, latents and output
    cotangent, gradients of every G parameter (mapping networks, field
    layers, the texture grid through the table), at the initial state and
    at the state after phase 6. Both round every product
    operand to bf16; they differ in the heads (bf16 operands in the
    kernels, f32 on the torch route) and in summation order.

    Printed as context, not held: the same comparison through a whole G
    microbatch render and loss with the same draws, at the initial state
    (three draw seeds at the step-0 sigma noise, one with none) and at the
    state after phase 6. A render's gradient is not a smooth function of
    such roundings where a sample's density sits at the ReLU's kink, so
    the torch route at f32 against bf16 is printed beside it."""
    from fenerf_tpu_torch.nn import fields
    from fenerf_tpu_torch.train import loop

    initial = loop.init_train_state(meta, seed=0, device=dev)
    fcfg = meta.field_config()
    bs = meta.batch_size // meta.batch_split
    n = meta.img_size ** 2 * meta.num_steps
    gen = torch.Generator(device=dev).manual_seed(7)
    pts = (torch.rand(bs, n, 3, generator=gen, device=dev) - 0.5) * 0.24
    dirs = torch.nn.functional.normalize(
        torch.randn(bs, n, 3, generator=gen, device=dev), dim=-1)
    zg = torch.randn(bs, fcfg.z_geo_dim, generator=gen, device=dev)
    za = torch.randn(bs, fcfg.z_app_dim, generator=gen, device=dev)
    g_out = torch.randn(bs, n, fcfg.output_dim, generator=gen, device=dev)

    def field_vjp(p, fcfg, rcfg):
        fg, fa = fields.field_film(p, fcfg, zg, za)
        out = fields.apply_field(p, fcfg, pts, dirs, fg, fa,
                                 compute_dtype=torch.bfloat16,
                                 backend=rcfg.backend)
        return (out * g_out).sum()

    state_after, steps_after = trained
    for label, state in (("initial", initial),
                         (f"after {steps_after} steps", state_after)):
        fk = _g_grads(state, meta, "kernel_train", "bfloat16", field_vjp)
        ft = _g_grads(state, meta, "torch", "bfloat16", field_vjp)
        cos, dn, n_cmp = _grad_compare(fk[1], ft[1])
        log(f"[grad] field VJP at B={bs} N={n}, {label}: kernel_train vs "
            f"torch bf16 over {n_cmp} parameter groups: worst cosine "
            f"{cos:.7f} (> {GRAD_COS}), worst norm difference {dn:.5f} "
            f"(< {GRAD_NORM})")
        if not (cos > GRAD_COS and dn < GRAD_NORM):
            raise AssertionError("kernel-route field gradient disagrees "
                                 f"with the torch route ({label})")
        del fk, ft

    as_t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    settings = [(f"initial, draws {seed}, noise {meta.nerf_noise(0)}",
                 initial, seed, meta.nerf_noise(0)) for seed in (5, 6, 7)]
    settings += [("initial, draws 5, noise 0", initial, 5, 0.0),
                  (f"after {steps_after} steps, draws 5, noise "
                   f"{meta.nerf_noise(steps_after)}", state_after, 5,
                   meta.nerf_noise(steps_after))]
    for label, state, seed, noise in settings:
        scal = loop.StepScalars(as_t(1.0), as_t(noise), as_t(1.0))
        draws = loop.make_step_draws(
            torch.Generator(device=dev).manual_seed(seed), meta,
            meta.batch_size, scal.noise_std, dev)
        z_g, z_a = (z[:bs] for z in draws.z_g)

        def render_loss(p, fcfg, rcfg):
            return loop._g_loss(p, state.d_img_params, state.d_seg_params,
                                fcfg, rcfg, meta, z_g, z_a, scal, 1,
                                draws.g_renders[0])[0]

        kern, bf, f32 = (_g_grads(state, meta, backend, cd, render_loss)
                         for backend, cd in (("kernel_train", "bfloat16"),
                                             ("torch", "bfloat16"),
                                             ("torch", "float32")))
        cos, dn, n_cmp = _grad_compare(kern[1], bf[1])
        ccos, cdn, _ = _grad_compare(f32[1], bf[1])
        log(f"[grad] render, {label}: G loss kernel {kern[0]:.6f}, torch "
            f"bf16 {bf[0]:.6f}, f32 {f32[0]:.6f}; kernel vs torch bf16 over "
            f"{n_cmp} groups: worst cosine {cos:.6f}, worst norm difference "
            f"{dn:.4f}; torch f32 vs torch bf16: worst cosine {ccos:.6f}, "
            f"worst norm difference {cdn:.4f}")
        if not all(math.isfinite(v) for v in (kern[0], bf[0], f32[0], cos,
                                              ccos)):
            raise AssertionError(f"non-finite G loss or gradient ({label})")
        del kern, bf, f32

# the editing workflow's entry points (fenerf_tpu_torch/apps/): multiview
# sheets at the CLI's defaults (256^2, 24 x 2 steps, hierarchical, psi 0.7,
# ray_chunk 4096), a 256^3 shape, and an inversion at 128^2 x 24 steps
MULTIVIEW_SEEDS = ("7", "8")      # the second sheet is timed warm
SHEET = (256 + 2 + 2, 5 * (256 + 2) + 2, 3)   # make_grid's padding of 2
INVERT_SIZE = 128
INVERT = ["--image_size", str(INVERT_SIZE), "--num_steps", "24",
          "--iterations", "60",
          "--eval_every", "20", "--lambda_seg", "1", "--lambda_img", "1",
          "--lambda_norm", "0"]
# the inversion's checkpoint: the serving one's weights with sigma bias +5
# (as the CPU tests') and the colour and label heads at SIREN's scale, 25x
# pi-GAN's small head init, so that colour and labels depend on W (on the
# serving checkpoint a W offset of 0.1 moves the objective by ~1e-6 of
# its 0.1989)
INVERT_VIDEO_FRAMES = 3   # the warm start's --render_video
INVERT_SIGMA_BIAS = 5.0
INVERT_HEAD_GAIN = 25.0
# the target: the CLI's own init W (init_seed 0, init_psi 0) plus this
# times one normal draw per W entry, rendered as a step renders, so that
# the inversion can reach it (60 Adam steps at lr 1e-2 move an entry by up
# to 0.6)
INVERT_OFFSET = 0.3
INVERT_OFFSET_SEED = 11
# the objective without the W noise, on the fitted path (kernel_train) and
# on fixed draws: at the known offset at least INVERT_GAP of its start
# below the start (the target lies within W's reach), and at the fitted
# offsets at most INVERT_CLOSE of that gap above the known offset's (the
# seg term's one-hot target lies out of any W's reach on random weights,
# so a share of the whole objective would mix in that floor)
INVERT_GAP = 0.01
INVERT_CLOSE = 0.5
# one step's loss, kernel route vs the torch route at bf16, relative: the
# same bf16 operands, f32 sums in another order; the pixels agree to 2e-2
# at most (phase 6), to bf16 rounding in the mean, which moves a mean of
# squared differences by about 1e-3
LOSS_TOL = 1e-2


def _app_films(ckpt, seed, dev, psi):
    """The apps' W for `seed`: the EMA tree, the truncation average from a
    generator seeded 42, the latents from one seeded `seed`."""
    from fenerf_tpu_torch.apps.common import load_generator
    from fenerf_tpu_torch.nn import fields

    _, params, _, cfg, _ = load_generator(ckpt, device=dev)
    with torch.no_grad():
        avg = fields.avg_film(params, cfg,
                              torch.Generator(device=dev).manual_seed(42))
        g = torch.Generator(device=dev).manual_seed(seed)
        zg = torch.randn((1, cfg.z_geo_dim), generator=g, device=dev)
        za = torch.randn((1, cfg.z_app_dim), generator=g, device=dev)
        fg, fa = fields.field_film(params, cfg, zg, za)
    return (params, cfg, fields.truncate_film(fg, avg[0], psi),
            fields.truncate_film(fa, avg[1], psi))


def phase_multiview(ckpt, tmp, dev) -> dict:
    """render_multiview at its defaults, once per ray route: two sheets
    each (the second timed warm), their PNGs, the launches of every kernel
    of the route; one view of the ray-kernel route against the torch ray
    route, and against the field's torch route at bf16 (phase 6's
    criterion)."""
    from fenerf_tpu_torch.apps import render_multiview
    from fenerf_tpu_torch.models import generator as gen
    from fenerf_tpu_torch.utils.image import read_png

    views, out = {}, {"launches": {}}
    for ray in ("never", "auto"):
        d = os.path.join(tmp, f"multiview_{ray}")
        with ray_kernels(ray):
            # --- the main path: counts from zero ---
            zero_counts()
            sheets = render_multiview.main(["--ckpt", ckpt, "--seeds",
                                            *MULTIVIEW_SEEDS,
                                            "--output_dir", d])
            launches, plain = read_counts()
        for seed, v, _ in sheets:
            if not (v.shape == (5, 22, 256, 256) and np.isfinite(v).all()):
                raise AssertionError(f"bad views {v.shape}")
            for kind in ("img", "seg"):
                png = read_png(os.path.join(d, f"{kind}_{seed}.png"))
                if png.shape != SHEET:
                    raise AssertionError(f"{kind}_{seed}.png {png.shape}")
        views[ray] = sheets[0][1][2]           # yaw offset 0 of seed 7
        # per sheet: 5 views x 16 ray blocks x 2 field evaluations
        blocks = 5 * len(sheets) * (256 * 256 // 4096)
        ray_n = blocks if ray == "auto" else 0
        log(f"[multiview ray={ray}] ms per 5-view sheet {sheets[1][2]:.1f} "
            f"(first {sheets[0][2]:.1f}); launches {launches}, plain "
            f"calls {plain}")
        if (launches["film_mlp"] != 2 * blocks
                or launches["ray_resample"] != ray_n
                or launches["ray_finalize"] != ray_n or plain != 0):
            raise AssertionError(f"multiview (ray={ray}) did not run "
                                 "through its kernels alone")
        out["launches"][ray] = launches
        out[f"ms_per_sheet_{ray}"] = sheets[1][2]
    err = float(np.abs(views["auto"] - views["never"]).max())
    # the same view with the field's torch route at bf16
    params, cfg, fg, fa = _app_films(ckpt, int(MULTIVIEW_SEEDS[0]), dev, 0.7)
    rcfg = gen.RenderConfig(img_size=256, num_steps=48, fill_mode=
                            "seg_padding_background", ray_chunk=4096,
                            compute_dtype="bfloat16", backend="torch")
    with ray_kernels("never"), torch.no_grad():
        torch_view = gen.render(
            params, cfg, rcfg, fg, fa, 1, camera=(math.pi / 2, math.pi / 2,
                                                  12.0),
            generator=torch.Generator(device=dev).manual_seed(0))[
                "pixels"][0].float().cpu().numpy()
    field_err = float(np.abs(views["never"] - torch_view).max())
    log(f"[multiview] one view: max|ray kernels - torch ray route| pixel "
        f"{err:.3e}, max|field kernel - torch field route (bf16)| pixel "
        f"{field_err:.3e} (tol {RENDER_TOL})")
    if not (err <= RENDER_TOL and field_err <= RENDER_TOL):
        raise AssertionError(f"multiview routes disagree: {err}, "
                             f"{field_err}")
    return out


def _ply_vertices(path):
    with open(path) as f:
        n_v = n_f = None
        for line in f:
            if line.startswith("element vertex"):
                n_v = int(line.split()[-1])
            elif line.startswith("element face"):
                n_f = int(line.split()[-1])
            elif line.startswith("end_header"):
                break
        verts = np.loadtxt(f, max_rows=n_v, dtype=np.float32, ndmin=2)
    return verts, n_f


SHAPES_CUBE = 0.3   # extract_shapes' defaults: a 256^3 lattice over a
SHAPES_RES = 256    # 0.3 cube


def phase_shapes(ckpt, tmp, tag="shapes") -> dict:
    """extract_shapes at its default lattice: the .mrc read back (shape,
    finite), no kernel launched and no plain version called (the lattice
    takes the field's torch route in f32, as the JAX package's takes
    XLA's); a mesh of that volume through the CLI's mesher
    (utils/marching.py::marching_cubes, write_ply, as --export_ply runs
    them) at an iso level inside its range (its 99.9th percentile),
    non-empty, its vertices inside the cube; seconds for the volume and
    the mesh."""
    from fenerf_tpu_torch.apps import extract_shapes
    from fenerf_tpu_torch.utils.marching import marching_cubes, write_ply
    from fenerf_tpu_torch.utils.mrc import read_mrc

    d = os.path.join(tmp, tag.replace(" ", "_"))
    zero_counts()
    (timing,) = extract_shapes.main(["--ckpt", ckpt, "--seeds", "7",
                                     "--output_dir", d])
    launches, plain = read_counts()
    vol = read_mrc(os.path.join(d, "shape_seed7.mrc"))
    if vol.shape != (SHAPES_RES,) * 3 or not np.isfinite(vol).all():
        raise AssertionError(f"[{tag}] bad volume {vol.shape}")
    if any(launches.values()) or plain:
        raise AssertionError(f"[{tag}] the lattice left its torch route: "
                             f"{launches}, plain calls {plain}")
    iso = float(np.quantile(vol, 0.999))
    vox = SHAPES_CUBE / SHAPES_RES
    t0 = time.perf_counter()
    verts, faces = marching_cubes(vol, level=iso, spacing=(vox,) * 3,
                                  origin=(-SHAPES_CUBE / 2,) * 3)
    ply = os.path.join(d, "shape_seed7.ply")
    write_ply(ply, verts, faces)
    timing["mesh_s"] = time.perf_counter() - t0
    verts, n_faces = _ply_vertices(ply)
    log(f"[{tag}] {SHAPES_RES}^3 volume {timing['volume_s']:.2f} s, mesh "
        f"{timing['mesh_s']:.2f} s ({len(verts)} vertices, {n_faces} faces "
        f"at iso {iso:.4f}); sigma in [{vol.min():.3f}, {vol.max():.3f}]")
    if not (vol.min() < iso < vol.max() and len(verts) > 0 and n_faces > 0):
        raise AssertionError(f"[{tag}] empty mesh")
    if np.abs(verts).max() > SHAPES_CUBE / 2 + 1e-6:
        raise AssertionError(f"[{tag}] mesh leaves the cube: "
                             f"{np.abs(verts).max()}")
    return timing


def phase_invert(ckpt, tmp, dev) -> dict:
    """invert at 128^2 x 24 steps, 60 iterations, an eval render every 20
    (FENERF_RAY_KERNELS=auto: the eval renders' hierarchy in the ray
    kernels), on `ckpt` (sigma bias INVERT_SIGMA_BIAS, head gain
    INVERT_HEAD_GAIN), against a target the port renders at the CLI's init
    W plus a known offset; the step losses fall, the objective without the
    W noise on the fitted path closes at least 1 - INVERT_CLOSE of its gap
    to the known offset's, the .npz and mious.npy are whole, a warm start
    keeps the first run's W + offsets as its base; the launches of both
    runs; the field's VJP w.r.t. the FiLM, kernel_train against the torch
    route (bf16), at a step's shape; the backward kernels against their
    plain version at this path's shape (B=1, 393,216 rows); one step's
    loss, kernel route against the torch route (bf16), held, and the
    cosine of its offset gradients, printed only (T7)."""
    from fenerf_tpu_torch.apps import invert
    from fenerf_tpu_torch.apps.common import load_generator
    from fenerf_tpu_torch.models import generator as gen
    from fenerf_tpu_torch.nn import fields
    from fenerf_tpu_torch.ops import film_mlp_grad as gops
    from fenerf_tpu_torch.utils.image import save_png, to_uint8

    _, params, _, cfg, _ = load_generator(ckpt, device=dev)

    def step_rcfg(backend, dtype):
        """A step's render (the CLI's), on `backend` at `dtype`."""
        return gen.RenderConfig(img_size=INVERT_SIZE, num_steps=24,
                                hierarchical=False, h_stddev=0.0,
                                v_stddev=0.0, sample_dist=None,
                                compute_dtype=dtype, backend=backend)

    # the target: init W + a known offset, rendered as a step renders (the
    # forward kernel); RGB, and labels 1-18 from the 18 label channels
    w0 = invert.init_w(params, cfg, 0, 0.0, dev)
    g = torch.Generator(device=dev).manual_seed(INVERT_OFFSET_SEED)
    known = {br: tuple(torch.randn(x.shape, generator=g, device=dev)
                       * INVERT_OFFSET for x in w0[br])
             for br in invert.BRANCHES}
    with torch.no_grad():
        pix = gen.render(
            params, cfg, step_rcfg("kernel", "bfloat16"),
            *invert.noisy_film(w0, known), 1, noise_std=0.0,
            generator=torch.Generator(device=dev).manual_seed(0))[
                "pixels"][0].float().cpu().numpy()
    img_p, seg_p = (os.path.join(tmp, f"target_{k}.png")
                    for k in ("rgb", "seg"))
    save_png(img_p, to_uint8(pix[-3:], normalize=False).transpose(1, 2, 0))
    save_png(seg_p, (np.argmax(pix[:-3], axis=0) + 1).astype(np.uint8))
    common = ["--ckpt", ckpt, "--image_path", img_p, "--seg_path", seg_p]
    with ray_kernels("auto"):
        # --- the main path: counts from zero ---
        zero_counts()
        res = invert.main(["target", *common, *INVERT,
                           "--save_dir", os.path.join(tmp, "inv")])
        warm = invert.main(["warm", *common, *INVERT[:4],
                            "--iterations", "1", "--lambda_seg", "1",
                            "--lambda_img", "1", "--load_offsets", res.path,
                            "--save_dir", os.path.join(tmp, "inv2"),
                            "--render_video", "--num_frames",
                            str(INVERT_VIDEO_FRAMES)])
        launches, plain = read_counts()
    log(f"[invert] {len(res.losses)} iterations: loss {res.losses[0]:.5f} "
        f"-> {res.losses[-1]:.5f}, mIoU {np.round(res.mious, 4).tolist()}; "
        f"{res.ms_per_iteration:.2f} ms per iteration, "
        f"{res.ms_per_eval:.2f} ms per eval render (+ mIoU); warm start "
        f"{warm.ms_per_iteration:.2f} ms per iteration; launches {launches}"
        f", plain calls {plain}")
    with np.load(res.path) as a, np.load(warm.path) as b:
        if len(a.files) != 12 or not all(np.isfinite(a[k]).all()
                                         for k in a.files):
            raise AssertionError(f"bad inversion checkpoint {a.files}")
        same = all(np.array_equal(b[f"w_{k}"], a[k]) for k in
                   ("freq_geo", "phase_geo", "freq_app", "phase_app"))
    if len(np.load(os.path.join(tmp, "inv", "mious.npy"))) != 3:
        raise AssertionError("mious.npy does not hold 3 entries")
    if not same:
        raise AssertionError("the warm start did not keep the prior W")
    from fenerf_tpu_torch.utils.video import read_avi

    frames, _ = read_avi(warm.video)
    log(f"[invert] --render_video: {warm.video} holds {frames.shape}")
    if frames.shape != (INVERT_VIDEO_FRAMES, 256, 3 * 256, 3):
        raise AssertionError(f"bad reconstruction video {frames.shape}")
    # per run: a forward and a backward per iteration; per eval render
    # and per video frame 8 ray blocks of 8192, two field evaluations each
    evals = 3 + 1 + INVERT_VIDEO_FRAMES
    want = {"film_mlp": 61 + evals * 16, "film_mlp_bwd": 61,
            "ray_resample": evals * 8, "ray_finalize": evals * 8}
    if any(launches[k] != v for k, v in want.items()) or plain != 0:
        raise AssertionError(f"invert did not run through its kernels "
                             f"alone: {launches}, {plain} plain, want {want}")

    # the loss falls: the steps' own losses, and the objective without the
    # W noise, on one fixed set of draws, on the path that was fitted
    # (kernel_train), at the start (zero offsets) and at the fitted offsets
    with np.load(res.path) as a:
        t = lambda k: torch.as_tensor(a[k], device=dev)
        w = {br: (t(f"w_freq_{br}"), t(f"w_phase_{br}")) for br in
             invert.BRANCHES}
        offsets = {br: (t(f"offset_freq_{br}"), t(f"offset_phase_{br}"))
                   for br in invert.BRANCHES}
    zero = {br: tuple(torch.zeros_like(x) for x in w[br])
            for br in invert.BRANCHES}
    tgt = invert.load_targets(img_p, seg_p, INVERT_SIZE, False)
    tt = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)

    def problem(backend, dtype):
        return invert.Problem(
            fields.with_grid_table(params, cfg, torch.bfloat16), cfg,
            step_rcfg(backend, dtype), w, tt(tgt[0]), tt(tgt[1]), 1.0, 1.0,
            0.0, 0.0, None, {"geo": 1.0, "app": 1.0})

    fitted = problem("kernel_train", "float32")
    draws = gen.draw_render(torch.Generator(device=dev).manual_seed(6), 1,
                            fitted.rcfg, 0.0, None, dev)
    with torch.no_grad():
        start, end, floor = (invert.loss_fn(fitted, o, zero, draws)[0].item()
                             for o in (zero, offsets, known))
    left = (end - floor) / (start - floor)
    log(f"[invert] the objective without W noise (kernel_train, fixed "
        f"draws): {start:.9f} at the start, {end:.9f} at the fitted "
        f"offsets ({end / start:.4f} of the start), {floor:.9f} at the "
        f"known one (the gap {(start - floor) / start:.4f} of the start, at "
        f"least {INVERT_GAP}; the fit leaves {left:.4f} of it, at most "
        f"{INVERT_CLOSE}); "
        f"the steps' own losses {res.losses[0]:.9f} -> "
        f"{res.losses[-1]:.9f}; the offsets' distance to the known one "
        f"{_offset_distance(offsets, known):.4f} (from zero "
        f"{_offset_distance(zero, known):.4f})")
    if not (start - floor >= INVERT_GAP * start and left <= INVERT_CLOSE
            and res.losses[-1] < res.losses[0]):
        raise AssertionError(f"the inversion's loss did not fall: "
                             f"{start} -> {end} (known offset {floor}), "
                             f"steps {res.losses[0]} -> "
                             f"{res.losses[-1]}")

    # the field's VJP w.r.t. the W-space FiLM, which is what the offsets'
    # gradients flow through, at a step's shape (B=1, 393,216 points) and
    # the fitted W: kernel_train against the torch route at bf16, held to
    # phase 9's criterion (T7: a whole render's gradient is not smooth in
    # the roundings, the field's VJP is)
    g = torch.Generator(device=dev).manual_seed(8)
    n = INVERT_SIZE ** 2 * 24
    pts = (torch.rand(1, n, 3, generator=g, device=dev) - 0.5) * 0.24
    dirs = torch.nn.functional.normalize(
        torch.randn(1, n, 3, generator=g, device=dev), dim=-1)
    g_out = torch.randn(1, n, cfg.output_dim, generator=g, device=dev)
    films = [x.detach().requires_grad_() for br in invert.noisy_film(
        w, offsets) for x in br]
    vjp = {}
    for backend in ("kernel_train", "torch"):
        out = fields.apply_field(fitted.params, cfg, pts, dirs, films[:2],
                                 films[2:], compute_dtype=torch.bfloat16,
                                 backend=backend)
        vjp[backend] = torch.autograd.grad((out * g_out).sum(), films)
        del out
    vjp_cos, vjp_norm, n_cmp = _grad_compare(vjp["kernel_train"],
                                             vjp["torch"])
    log(f"[invert] field VJP w.r.t. the W-space FiLM at B=1 N={n}, fitted "
        f"W: kernel_train vs torch bf16 over {n_cmp} groups (freq / phase, "
        f"geo / app): worst cosine {vjp_cos:.7f} (> {GRAD_COS}), worst "
        f"norm difference {vjp_norm:.5f} (< {GRAD_NORM})")
    if not (vjp_cos > GRAD_COS and vjp_norm < GRAD_NORM):
        raise AssertionError("the inversion's FiLM gradient through the "
                             "kernels disagrees with the torch route")
    del vjp, films, pts, dirs, g_out

    # the backward kernels at this path's shape
    cfg3, params3, gen3 = _flagship_params(dev, seed=4)
    params3 = fields.with_grid_table(params3, cfg3, torch.bfloat16)
    bwd = _bwd_case(cfg3, params3, gops.pack_bwd(params3, cfg3), gen3,
                    1, 128 * 128 * 24, dev, tag="[invert backward]")

    # one step's loss and offset gradients: kernel route vs the torch route
    # (bf16) on the same draws
    losses, grads = {}, {}
    for backend, dtype in (("kernel_train", "float32"),
                           ("torch", "bfloat16")):
        prob = problem(backend, dtype)
        g = torch.Generator(device=dev).manual_seed(5)
        noise, draws = invert.step_draws(g, prob, 0.01, dev)
        (losses[backend], _, _), grads[backend] = invert.loss_and_grads(
            prob, offsets, noise, draws)
        if backend == "kernel_train":
            # where a step's device time goes: the kernels' own durations
            # in the profiler (the dW kernel runs although no parameter
            # takes a gradient)
            step_dev = _device_groups(
                lambda: invert.loss_and_grads(prob, offsets, noise, draws),
                ("film_mlp_kernel", "bwd_rows_kernel", "dw_kernel",
                 "reduce_kernel"))
            log(f"[invert] a step's device time (loss and gradients, "
                f"profiler, mean of 3): " + ", ".join(
                    f"{k} {v:.3f} ms" for k, v in step_dev.items()))
    cos = {}
    for br in invert.BRANCHES:
        for k, name in enumerate(("freq", "phase")):
            a = grads["kernel_train"][br][k].double().ravel()
            b = grads["torch"][br][k].double().ravel()
            cos[f"{name}_{br}"] = float(a @ b / (a.norm() * b.norm()))
    loss_k, loss_t = (losses[k].item() for k in ("kernel_train", "torch"))
    loss_err = abs(loss_k - loss_t) / abs(loss_t)
    log(f"[invert] one step's loss, kernel route {loss_k:.9f}, torch route "
        f"(bf16) {loss_t:.9f}: relative difference {loss_err:.3e} (tol "
        f"{LOSS_TOL}); its offset gradients, cosine kernel route vs torch "
        "route (printed, not held: T7): "
        + " ".join(f"{k} {v:.6f}" for k, v in cos.items()))
    if not loss_err <= LOSS_TOL:
        raise AssertionError(f"a step's loss, kernel route vs torch route: "
                             f"{loss_k} vs {loss_t}")
    return {"launches": launches, "ms_per_iteration": res.ms_per_iteration,
            "ms_per_eval": res.ms_per_eval, "bwd": bwd, "cosine": cos,
            "step_device_ms": step_dev, "loss_rel_err": loss_err,
            "film_vjp_cos": vjp_cos, "film_vjp_norm": vjp_norm}


def _offset_distance(offsets, known) -> float:
    """The norm of offsets - known over every W leaf (geo and app)."""
    return math.sqrt(sum(float(((o - k) ** 2).sum()) for br in known
                         for o, k in zip(offsets[br], known[br])))


def _device_groups(fn, names, iters=3) -> dict:
    """Device ms per call of fn: each named kernel's, the rest, and the
    total (torch.profiler's CUDA kernel records)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {k: 0.0 for k in (*names, "other", "total")}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / iters / 1e3
        out[next((k for k in names if k in evt.key), "other")] += ms
        out["total"] += ms
    return out


# the ceiling-probe scripts, the slice's entry points (scripts/)
PROBE_SCRIPTS = ("profile_torch_mxu_chain", "profile_torch_epilogue_overlap",
                 "profile_torch_dma_gather")
PROBE_KERNELS = ("run_chain", "run_wide", "run_epi", "ring_dma_gather")
# probe kernels vs plain versions. Chains, max|diff| / max|plain|: bf16
# operands on both sides, f32 sums in another order; a linear chain carries
# the resulting bf16 flips (~5e-3 relative at 11 layers)
CHAIN_TOL = 2e-2
# the FiLM chain at the field's weight scale over 11 layers, values in
# [-1, 1]: bf16 flips grow with depth and with the number of rows, so RMS
# holds the kernel and max only bounds the tail; a zeroed or shifted row
# fails both
EPI_RMS_TOL, EPI_MAX_TOL = 5e-3, 2.5e-1
# the FiLM chain on the script's draw (W ~ N(0, 1/256), f ~ N(30, 15^2)) is
# chaotic from layer 3 on (tests/test_torch_mxu_chain.py shows it): held
# over 1 layer, one bf16 rounding apart
EPI1_TOL = 2e-2


def _probe_script(name: str):
    """scripts/<name>.py as a module (scripts/ is not a package)."""
    path = Path(__file__).resolve().parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_probe_scripts() -> tuple[dict, dict]:
    """The slice's main path: the three ceiling-probe scripts at their full
    shapes, 3 timed calls per variant. Returns (launches of each probe
    kernel, the scripts' results by script and variant)."""
    mods = [_probe_script(name) for name in PROBE_SCRIPTS]
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        # --- the main path: counts from zero ---
        zero_counts()
        for name, mod in zip(PROBE_SCRIPTS, mods):
            out = os.path.join(tmp, f"{name}.json")
            if mod.main(["--iters", "3", "--out", out]) != 0:
                raise AssertionError(f"{name} failed")
            with open(out) as f:
                results[name] = json.load(f)["variants"]
        launches, plain = read_counts()
    probe = {k: launches[k] for k in PROBE_KERNELS}
    log(f"[probes] scripts' launches {probe}, plain-version calls {plain}")
    if not all(probe.values()) or plain != 0:
        raise AssertionError("the probe scripts did not run through their "
                             "kernels alone")
    return probe, results


def _chain_variant(name: str) -> dict:
    """tile / interleave of a probe script's variant name (chain_t64, ilv2_t128,
    epi_ilv2_t128, wide_t128)."""
    tile = int(name.rsplit("_t", 1)[1])
    k = int(name.split("ilv")[1].split("_")[0]) if "ilv" in name else 1
    return {"tile": tile, "interleave": k}


def phase_probes(dev, results: dict) -> dict:
    """Each probe kernel against its plain version at the probe scripts' full
    shapes, at every tile / interleave the probe scripts ran; timed (the
    fastest variant) beside the plain version and the library call.
    Returns the kernels' records by name."""
    from fenerf_tpu_torch.ops import dma_gather as dg
    from fenerf_tpu_torch.ops import mxu_chain as mc
    from fenerf_tpu_torch.ops import probes as pr

    gen = torch.Generator(device=dev).manual_seed(12)
    mxu = results["profile_torch_mxu_chain"]
    epi = results["profile_torch_epilogue_overlap"]
    out = {}

    def matmuls(a, ws):
        for w in ws:
            a = a @ w
        return a

    # --- the chains: every tile / interleave against one plain result ---
    for kname, prefix, (n, h, layers), fn in (
            ("run_chain", ("chain_", "ilv"), (pr.N_PTS, pr.H, pr.LAYERS),
             mc.run_chain),
            ("run_wide", ("wide_",), (pr.WIDE_N, pr.WIDE_H, pr.WIDE_LAYERS),
             lambda x, w, tile, interleave: mc.run_wide(x, w, tile))):
        x, w = pr.chain_inputs(gen, n, h, layers, dev)
        ref = mc.chain_reference(x, w)
        scale = ref.float().abs().max().item()
        names = [k for k in mxu if k.startswith(prefix)]
        outs = {k: fn(x, w, **_chain_variant(k)) for k in names}
        torch.cuda.synchronize()
        errs = {k: (o.float() - ref.float()).abs().max().item()
                for k, o in outs.items()}
        first = outs[names[0]]
        same = all(torch.equal(o, first) for o in outs.values())
        best = min(names, key=lambda k: mxu[k]["ms"])
        del outs, first
        v = _chain_variant(best)
        ms = time_ms(lambda: fn(x, w, **v), 10)
        plain_ms = time_ms(lambda: mc.chain_reference(x, w), 3, warmup=1)
        mm_ms = time_ms(lambda: matmuls(x, w), 10)
        bound, by = bound_ms(*pr.chain_cost(n, h, layers))
        err = max(errs.values())
        log(f"[probes] {kname} ({n}, {h}) x {layers} layers: max|kernel-"
            f"plain|/max|plain| {err / scale:.3e} (tol {CHAIN_TOL}) over "
            f"{names}; all variants bitwise equal {same}; {best} {ms:.4f} "
            f"ms ({pr.chain_cost(n, h, layers)[0] / ms / 1e9:.1f} TFLOP/s), "
            f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}); context: "
            f"{layers} torch.matmul bf16 calls {mm_ms:.4f} ms")
        if not err / scale <= CHAIN_TOL:
            raise AssertionError(f"{kname} disagrees with plain: {errs}")
        if not same:
            raise AssertionError(f"{kname}: variants {names} differ")
        out[kname] = {"variant": best, "max_abs_err": err,
                      "max_rel_err": err / scale, "variants_equal": same,
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by, "library_ms": None,
                      "torch_matmul_chain_ms": mm_ms}
        del x, w, ref

    # --- the FiLM chain: field scale over 11 layers, script draw over 1 ---
    n, h, layers = pr.N_PTS, pr.H, pr.LAYERS
    x = pr.activations(gen, n, h, dev)
    rows, errs_max, unequal = [], [], []
    for scale, nl in (("field", layers), ("script", 1)):
        w, b, f, p = pr.film_inputs(gen, nl, h, dev, scale)
        for fold in (False, True):
            kind = "fold" if fold else "epi"
            ref = mc.epi_reference(x, w, b, f, p, fold=fold).float()
            names = [k for k in epi if k.startswith(kind + "_")]
            first = None
            for k in names:
                out_k = mc.run_epi(x, w, b, f, p, fold=fold,
                                   **_chain_variant(k))
                if first is None:
                    first = out_k
                elif not torch.equal(out_k, first):
                    unequal.append((scale, k, names[0]))
                d = out_k.float() - ref
                mx = d.abs().max().item()
                rms = d.square().mean().sqrt().item()
                ok = (mx <= EPI1_TOL if nl == 1 else
                      rms <= EPI_RMS_TOL and mx <= EPI_MAX_TOL)
                rows.append({"scale": scale, "layers": nl, "variant": k,
                             "max_abs_err": mx, "rms_err": rms, "ok": ok})
                errs_max.append(mx)
                del out_k, d
            del ref, first
        if scale == "script":
            best = min((k for k in epi if k.startswith("epi_")),
                       key=lambda k: epi[k]["ms"])
            v = _chain_variant(best)
            wl, bl, fl, pl = pr.film_inputs(gen, layers, h, dev, scale)
            ms = time_ms(lambda: mc.run_epi(x, wl, bl, fl, pl, **v), 10)
            plain_ms = time_ms(lambda: mc.epi_reference(x, wl, bl, fl, pl),
                               3, warmup=1)
            chain_ms = time_ms(lambda: mc.run_chain(x, wl, **v), 10)
            del wl
    for r in rows:
        log(f"[probes] run_epi {r['variant']} at the {r['scale']} scale over "
            f"{r['layers']} layer(s): max|kernel-plain| {r['max_abs_err']:.3e}"
            f", RMS {r['rms_err']:.3e} (tol: " + (
                f"max {EPI1_TOL}" if r["layers"] == 1 else
                f"RMS {EPI_RMS_TOL}, max {EPI_MAX_TOL}") + ")")
    bound, by = bound_ms(*pr.chain_cost(n, h, layers))
    log(f"[probes] run_epi variants bitwise equal to each other: "
        f"{not unequal} {unequal}")
    log(f"[probes] run_epi {best} (script draw, 11 layers) {ms:.4f} ms, "
        f"run_chain at its variant {chain_ms:.4f} ms (the epilogue adds "
        f"{ms - chain_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({by})")
    if not all(r["ok"] for r in rows):
        raise AssertionError("run_epi disagrees with plain: "
                             f"{[r for r in rows if not r['ok']]}")
    if unequal:
        raise AssertionError(f"run_epi: variants differ: {unequal}")
    out["run_epi"] = {"variant": best, "max_abs_err": max(errs_max),
                      "variants_equal": not unequal,
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by, "library_ms": None,
                      "chain_ms": chain_ms, "shapes": rows}
    del x

    # --- the gather: bit-exact, 2 KB and 512 B rows, and with the chain ---
    gscript = _probe_script("profile_torch_dma_gather")
    cases = []
    for row_shape, rings_ in ((pr.ROW_TPU, gscript.RINGS),
                              (pr.ROW_FLAGSHIP, gscript.RINGS_512B)):
        table, idx = pr.table_inputs(gen, row_shape, pr.N_IDX, dev)
        ref = dg.gather_reference(table, idx)
        row_bytes = 2 * table[0].numel()
        bound, by = bound_ms(0, pr.gather_bytes(pr.N_IDX, row_bytes))
        lib_ms = time_ms(lambda: table.index_select(0, idx), 10)
        for ring in rings_:
            got = dg.ring_dma_gather(table, idx, ring)
            torch.cuda.synchronize()
            exact = torch.equal(got, ref)
            del got
            ms = time_ms(lambda: dg.ring_dma_gather(table, idx, ring), 10)
            cases.append({"row_bytes": row_bytes, "ring": ring,
                          "bitwise": exact, "ms": ms, "library_ms": lib_ms,
                          "bound_ms": bound, "bound_by": by})
        if row_shape == pr.ROW_TPU:
            plain_ms = time_ms(lambda: dg.gather_reference(table, idx), 10)
            x, w = pr.chain_inputs(gen, pr.N_IDX, pr.H, pr.LAYERS, dev)
            act_ref = mc.chain_reference(x, w)
            flops, chain_bytes = pr.chain_cost(pr.N_IDX, pr.H, pr.LAYERS)
            # the overlap over 16 B rows: the chain's own time in the kernel
            small, idx16 = pr.table_inputs(gen, (8,), pr.N_IDX, dev)
            for tab, ix, rb in ((table, idx, row_bytes), (small, idx16, 16)):
                ring = 32
                rows_o, act = dg.ring_dma_gather(tab, ix, ring, ws=w, x=x,
                                                 overlap=True)
                torch.cuda.synchronize()
                act_err = ((act.float() - act_ref.float()).abs().max()
                           / act_ref.float().abs().max()).item()
                exact = torch.equal(rows_o, dg.gather_reference(tab, ix))
                del rows_o, act
                ms = time_ms(lambda: dg.ring_dma_gather(
                    tab, ix, ring, ws=w, x=x, overlap=True), 10)
                ob, oby = bound_ms(flops, pr.gather_bytes(pr.N_IDX, rb)
                                   + chain_bytes)
                cases.append({"row_bytes": rb, "ring": ring,
                              "overlap": True, "bitwise": exact,
                              "chain_max_rel_err": act_err, "ms": ms,
                              "bound_ms": ob, "bound_by": oby})
            del x, w, act_ref, small, idx16
        del table, idx, ref
    for c in cases:
        log(f"[probes] ring_dma_gather {c['row_bytes']} B rows, ring "
            f"{c['ring']}{', with the chain' if c.get('overlap') else ''}: "
            f"bitwise equal to index_select {c['bitwise']}"
            + (f", chain max|kernel-plain|/max|plain| "
               f"{c['chain_max_rel_err']:.3e} (tol {CHAIN_TOL})"
               if c.get("overlap") else "")
            + f"; {c['ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
            f"({c['bound_by']}), {c['bound_ms'] / c['ms']:.1%} of it"
            + (f", index_select {c['library_ms']:.4f} ms"
               if "library_ms" in c else ""))
    if not all(c["bitwise"] and c.get("chain_max_rel_err", 0) <= CHAIN_TOL
               for c in cases):
        raise AssertionError(f"ring_dma_gather disagrees: {cases}")
    over = {c["row_bytes"]: c["ms"] for c in cases if c.get("overlap")}
    log(f"[probes] beside the chain (ring 32) the 2 KB gather adds "
        f"{over[2048] - over[16]:.4f} ms to the 16 B-row overlap's "
        f"{over[16]:.4f} ms")
    best = {rb: min((c for c in cases if c["row_bytes"] == rb
                     and not c.get("overlap")), key=lambda c: c["ms"])
            for rb in (2048, 512)}
    out["ring_dma_gather"] = {
        "variant": f"ring_dma_r{best[2048]['ring']}", "max_abs_err": 0.0,
        "ms": best[2048]["ms"], "plain_ms": plain_ms,
        "bound_ms": best[2048]["bound_ms"],
        "bound_by": best[2048]["bound_by"],
        "library_ms": best[2048]["library_ms"],
        "ms_512b": best[512]["ms"], "bound_ms_512b": best[512]["bound_ms"],
        "library_ms_512b": best[512]["library_ms"],
        "overlap_ms": over[2048], "overlap_16b_ms": over[16],
        "shapes": cases}
    return out


# ---------------------------------------------------------------------------
# config 4: free-viewpoint video, and the latent-grid family's other paths
# ---------------------------------------------------------------------------

GRID = "SPATIALSIRENGRID"   # published widths: z 256, hidden 256, 8 trunk
                            # layers, a 32 x 32 x 32 plane, ch_max 256
VIDEO_FRAMES = 36           # render_video's defaults: 128^2, 24 + 24
VIDEO_BLOCKS = 128 * 128 // 4096   # steps, ray_chunk 4096
# the film video's frames held to the torch routes: both ends and one
# interpolated between them
VIDEO_REF_FRAMES = (0, VIDEO_FRAMES // 2, VIDEO_FRAMES - 1)
VIDEO_SIZE = 128
def _grid_params(dev):
    """SPATIALSIRENGRID at its published widths, random weights (seed 3),
    the sigma head's bias raised by SIGMA_BIAS (an opaque volume)."""
    from fenerf_tpu_torch.nn import latent_grid_field as lgf

    cfg = lgf.get_grid_config(GRID)
    params = lgf.init_grid_field(torch.Generator(device=dev).manual_seed(3),
                                 cfg, device=dev)
    params["sigma_head"]["b"] = params["sigma_head"]["b"] + SIGMA_BIAS
    return cfg, params


def write_grid_checkpoint(dev, tmp) -> str:
    """_grid_params as a generator .npz of the grid family."""
    from fenerf_tpu_torch.apps.common import save_generator

    cfg, params = _grid_params(dev)
    ckpt = os.path.join(tmp, "generator_grid.npz")
    save_generator(ckpt, params, params, params, GRID, step=0)
    log(f"[grid] wrote {GRID} checkpoint (z {cfg.z_dim}, hidden "
        f"{cfg.hidden_dim}, {cfg.trunk_layers} trunk layers, plane "
        f"{cfg.grid_ch} x {cfg.grid_res}^2, ch_max {cfg.ch_max}), sigma "
        f"bias {SIGMA_BIAS:+g} ({os.path.getsize(ckpt) / 2**20:.0f} MiB)")
    return ckpt


def _check_video(video, size, channels, panels, tag):
    """The .avi read back equals the frames written; shapes; finite."""
    from fenerf_tpu_torch.utils.video import read_avi

    frames, fps = read_avi(video.path)
    if not (frames.shape == (VIDEO_FRAMES, size, panels * size, 3)
            and fps == 12.0 and np.array_equal(frames, video.frames)):
        raise AssertionError(f"{tag}: {video.path} reads back "
                             f"{frames.shape} at {fps} fps, not the frames")
    if not (video.pixels.shape == (VIDEO_FRAMES, channels, size, size)
            and np.isfinite(video.pixels).all()):
        raise AssertionError(f"{tag}: bad pixels {video.pixels.shape}")


def phase_grid_video(ckpt, tmp, dev) -> dict:
    """(a) render_video on the grid checkpoint at its defaults (128^2, 24 +
    24 steps, 36 frames, front, geo), once per ray route: the .avi read
    back equal to the frames, ms per frame, the launches of the route (on
    auto, VIDEO_BLOCKS of each ray kernel per frame; no field kernel, the
    grid field is torch); the kernel route's frames against the torch
    route's (RENDER_TOL); a chunked frame (the CLI's first) against the
    same frame rendered whole, bit-exact, on each route."""
    from fenerf_tpu_torch.apps import render_video
    from fenerf_tpu_torch.apps.common import (best_backend,
                                              camera_trajectory,
                                              load_generator)

    out, videos = {"launches": {}}, {}
    for ray in ("never", "auto"):
        with ray_kernels(ray):
            # --- the main path: counts from zero ---
            zero_counts()
            (video,) = render_video.main([
                "--ckpt", ckpt, "--output_dir",
                os.path.join(tmp, f"video_grid_{ray}")])
            launches, plain = read_counts()
        _check_video(video, VIDEO_SIZE, 3, 2, f"grid video ray={ray}")
        ray_n = VIDEO_FRAMES * VIDEO_BLOCKS if ray == "auto" else 0
        log(f"[grid video ray={ray}] {VIDEO_FRAMES} frames, "
            f"{video.ms_per_frame:.1f} ms per frame; launches {launches}, "
            f"plain calls {plain}")
        if (launches["film_mlp"] != 0 or launches["ray_resample"] != ray_n
                or launches["ray_finalize"] != ray_n or plain != 0):
            raise AssertionError(f"grid video (ray={ray}) did not run "
                                 "through its kernels alone")
        out["launches"][ray] = launches
        out[f"ms_per_frame_{ray}"] = video.ms_per_frame
        videos[ray] = video
    err = float(np.abs(videos["auto"].pixels
                       - videos["never"].pixels).max())
    log(f"[grid video] max|ray kernels - torch ray route| pixel {err:.3e} "
        f"over {VIDEO_FRAMES} frames (tol {RENDER_TOL}); mean pixel "
        f"{videos['never'].pixels.mean():.4f}")
    if not err <= RENDER_TOL:
        raise AssertionError(f"grid video routes disagree: {err}")

    # a chunked frame against the whole-image frame: the CLI's first frame
    # (t = 0: seed 0's z exactly) and the same render with ray_chunk 0
    args = render_video.parse_args(["--ckpt", ckpt, "--ray_chunk", "0"])
    _, params, _, cfg, _ = load_generator(ckpt, device=dev)   # the EMA
    rcfg = render_video.render_config(args, cfg, best_backend(cfg, dev))
    films_for_seed, render_frame = render_video.frame_renderer(
        params, cfg, rcfg, args.psi, dev)
    _, pitch, yaw, fov = camera_trajectory(args.trajectory, args.num_frames,
                                           12.0)[0]
    for ray in ("never", "auto"):
        with ray_kernels(ray), torch.no_grad():
            whole = render_frame(*films_for_seed(0), (pitch, yaw, fov),
                                 render_video.frame_draws(rcfg, dev))
        whole = whole["pixels"][0].cpu().numpy()
        same = np.array_equal(whole, videos[ray].pixels[0])
        log(f"[grid video ray={ray}] frame 0, ray_chunk 4096 vs whole "
            f"image: bit-exact {same}, max|diff| "
            f"{np.abs(whole - videos[ray].pixels[0]).max():.3e}")
        if not same:
            raise AssertionError(f"grid video (ray={ray}): the chunked frame "
                                 "differs from the whole image")
    return out


def phase_film_video(ckpt, tmp, dev) -> dict:
    """(b) render_video on the serving checkpoint at its defaults, the
    field on its kernel and the rays under FENERF_RAY_KERNELS=auto: the
    .avi read back, ms per frame, launches (per frame VIDEO_BLOCKS ray
    blocks: two field evaluations each, one of each ray kernel); frames
    VIDEO_REF_FRAMES held to the same frames on the field's torch route
    at bf16 and the torch ray route (RENDER_TOL), rendered with the CLI's
    own settings, films, draws and cameras."""
    from fenerf_tpu_torch.apps import render_video
    from fenerf_tpu_torch.apps.common import (camera_trajectory,
                                              interpolate_films,
                                              load_generator)

    with ray_kernels("auto"):
        # --- the main path: counts from zero ---
        zero_counts()
        (video,) = render_video.main(["--ckpt", ckpt, "--output_dir",
                                      os.path.join(tmp, "video_film")])
        launches, plain = read_counts()
    _check_video(video, VIDEO_SIZE, 22, 4, "film video")
    blocks = VIDEO_FRAMES * VIDEO_BLOCKS
    log(f"[film video ray=auto] {VIDEO_FRAMES} frames, "
        f"{video.ms_per_frame:.1f} ms per frame; launches {launches}, plain "
        f"calls {plain}")
    if (launches["film_mlp"] != 2 * blocks
            or launches["ray_resample"] != blocks
            or launches["ray_finalize"] != blocks or plain != 0):
        raise AssertionError("film video did not run through its kernels "
                             "alone")

    args = render_video.parse_args(["--ckpt", ckpt])
    _, params, _, cfg, _ = load_generator(ckpt, device=dev)   # the EMA
    rcfg = render_video.render_config(args, cfg, "torch")
    films_for_seed, render_frame = render_video.frame_renderer(
        params, cfg, rcfg, args.psi, dev)
    traj = camera_trajectory(args.trajectory, args.num_frames, 12.0)
    draws = render_video.frame_draws(rcfg, dev)
    err, t_ref = 0.0, 0.0
    with ray_kernels("never"), torch.no_grad():
        ends = films_for_seed(0), films_for_seed(1)
        for i in VIDEO_REF_FRAMES:
            t, pitch, yaw, fov = traj[i]
            fg, fa = (interpolate_films(ends[0][k], ends[1][k], t,
                                        args.latent_type, part)
                      for k, part in enumerate(("geo", "app")))
            t0 = time.perf_counter()
            ref = render_frame(fg, fa, (pitch, yaw, fov), draws)["pixels"]
            ref = ref[0].float().cpu().numpy()
            t_ref += time.perf_counter() - t0
            err = max(err, float(np.abs(video.pixels[i] - ref).max()))
    ms_ref = t_ref / len(VIDEO_REF_FRAMES) * 1e3
    log(f"[film video] max|kernels - torch routes (bf16)| pixel {err:.3e} "
        f"over frames {VIDEO_REF_FRAMES} (tol {RENDER_TOL}); torch routes "
        f"{ms_ref:.1f} ms per frame")
    if not err <= RENDER_TOL:
        raise AssertionError(f"film video disagrees with the torch route: "
                             f"{err}")
    return {"launches": launches, "ms_per_frame": video.ms_per_frame,
            "ms_per_frame_torch": ms_ref}


def phase_grid_apps(ckpt, tmp) -> dict:
    """(c) The grid family's other paths: a render_multiview sheet at its
    defaults (256^2, 24 x 2 steps, ray kernels on: 5 views x 16 blocks of
    each), timed; extract_shapes at 256^3 with a mesh (the finiteness and
    mesh checks of phase 5b); a request through serve (the torch route for
    field and rays, no kernel launched)."""
    from fenerf_tpu_torch.apps import render_multiview
    from fenerf_tpu_torch.apps.serve import build_renderer
    from fenerf_tpu_torch.utils.image import read_png

    d = os.path.join(tmp, "multiview_grid")
    with ray_kernels("auto"):
        # --- the main path: counts from zero ---
        zero_counts()
        ((seed, views, ms),) = render_multiview.main([
            "--ckpt", ckpt, "--seeds", "7", "--output_dir", d])
        launches, plain = read_counts()
    png = read_png(os.path.join(d, "img_7.png"))
    blocks = 5 * 256 * 256 // 4096
    log(f"[grid multiview] ms per 5-view sheet {ms:.1f}; launches "
        f"{launches}, plain calls {plain}")
    if not (views.shape == (5, 3, 256, 256) and np.isfinite(views).all()
            and png.shape == SHEET
            and not os.path.exists(os.path.join(d, "seg_7.png"))):
        raise AssertionError(f"grid multiview: views {views.shape}, sheet "
                             f"{png.shape}")
    if (launches["film_mlp"] != 0 or launches["ray_resample"] != blocks
            or launches["ray_finalize"] != blocks or plain != 0):
        raise AssertionError("grid multiview did not run through its "
                             "kernels alone")

    timing = phase_shapes(ckpt, tmp, "grid shapes")

    with ray_kernels("auto"):
        zero_counts()
        render_np, meta = build_renderer(ckpt, device="cuda", **SERVE)
        srv, base = _serve(render_np, meta)
        try:
            t0 = time.perf_counter()
            body = _get(f"{base}/render?seed=3&yaw=0.2&kind=rgb")
            first = time.perf_counter() - t0
            t0 = time.perf_counter()
            again = _get(f"{base}/render?seed=3&yaw=0.2&kind=rgb")
            dt = time.perf_counter() - t0
        finally:
            srv.shutdown()
            srv.server_close()
        serve_launches, serve_plain = read_counts()
    log(f"[grid serve] backend {meta['backend']}, ray route "
        f"{meta['ray_route']}: one rgb request {first * 1e3:.1f} ms (first), "
        f"{dt * 1e3:.1f} ms (again); launches {serve_launches}, plain calls "
        f"{serve_plain}")
    if (body[:8] != PNG_MAGIC or body != again or struct.unpack(
            ">II", body[16:24]) != (SERVE["image_size"],) * 2):
        raise AssertionError("grid serve: not the same 128^2 PNG twice")
    if (meta["family"], meta["backend"], meta["ray_route"]) != (
            "grid", "torch", "torch") or any(serve_launches.values()) \
            or serve_plain:
        raise AssertionError(f"grid serve did not take the torch route: "
                             f"{meta}, {serve_launches}")
    return {"launches": launches, "ms_per_sheet": ms,
            "volume_s": timing["volume_s"], "mesh_s": timing["mesh_s"],
            "serve_ms": dt * 1e3}


# ---------------------------------------------------------------------------
# 5g. the edit loop: the editing workflow's mask half through the CLIs'
# mains on the card (parse -> edit / paint -> invert -> replay -> score ->
# HD), every weights file a seeded stand-in written into the temp directory
# ---------------------------------------------------------------------------

EDIT_PARSE_SIZE = 512   # prepare_segmaps --size
# BiSeNet's logits, card against the CPU, relative to each image's largest:
# f32 convolutions with TF32 off on both sides, in another order; the label
# maps are held wherever the top-two margin exceeds it
BISENET_TOL = 1e-4
# invert against the JPEG photo and the edited map: the kernel_train route,
# the ray kernels on, 30 iterations, an eval render every 15
EDIT_INVERT = ["--image_size", "128", "--num_steps", "24", "--iterations",
               "30", "--eval_every", "15", "--lambda_seg", "1",
               "--lambda_img", "1", "--lambda_norm", "0"]
EDIT_ITERATIONS = 30
EDIT_SCORE_IMAGES = 16   # renders per directory for eval_metrics
# a directory scored against itself: FID up to sqrtm's rounding; KID's
# unbiased estimate is ~0, not 0 (its cross term keeps the diagonal the
# within-set terms drop)
EDIT_FID_SELF = 1e-3
EDIT_KID_SELF = 1e-4
HD = "SPATIALSIRENSEMANTICHD"
HD_SIZE = 256            # render_multiview --hd --image_size
HD_FEATURES = 64         # the heads upsample 64^2 features 4x
# the neural renderers on the card against the CPU at f32, relative to the
# output's largest value: TF32 off on both sides, another order
NR_TOL = 1e-4


def _edit_counts(launches, want, tag):
    """Fails unless the launches equal `want` (every other kernel 0) and no
    plain version ran."""
    counts, plain = launches
    full = {k: want.get(k, 0) for k in counts}
    if counts != full or plain:
        raise AssertionError(f"[edit] {tag}: launches {counts}, plain calls "
                             f"{plain}; want {full}")
    return counts


def _render_face(ckpt, dev, path):
    """The serving checkpoint's EMA at EDIT_PARSE_SIZE^2 (24 + 24 steps,
    psi 0.7, ray_chunk 4096, the field kernel), saved as a PNG."""
    from fenerf_tpu_torch.models import generator as gen
    from fenerf_tpu_torch.nn import fields
    from fenerf_tpu_torch.ops import film_mlp
    from fenerf_tpu_torch.utils.image import save_png, to_uint8

    params, cfg, fg, fa = _app_films(ckpt, 7, dev, 0.7)
    rcfg = gen.RenderConfig(img_size=EDIT_PARSE_SIZE, num_steps=48,
                            fill_mode="seg_padding_background",
                            ray_chunk=4096, compute_dtype="bfloat16",
                            backend="kernel")
    params = film_mlp.with_pack(
        fields.with_grid_table(params, cfg, torch.bfloat16), cfg)
    with torch.no_grad():
        pix = gen.render(params, cfg, rcfg, fg, fa, 1,
                         camera=(math.pi / 2, math.pi / 2, 12.0),
                         generator=torch.Generator(device=dev).manual_seed(0))
    pix = pix["pixels"][0].float().cpu().numpy()
    save_png(path, to_uint8(pix[-3:], normalize=False).transpose(1, 2, 0))


def _read_maps(masks, files):
    from fenerf_tpu_torch.utils.image import read_png

    return np.stack([read_png(os.path.join(
        masks, os.path.splitext(os.path.basename(f))[0] + ".png"))
        for f in files])


def _edit_parse(ckpt, tmp, dev) -> dict:
    """Parse: a 512^2 face rendered by the serving checkpoint and a
    committed 1024^2 fixture JPEG through prepare_segmaps --size 512
    --colorize (one image per BiSeNet call, the default) on a seeded
    segNet-20Class-layout state_dict; BiSeNet's logits on the card against
    the CPU's on the same inputs, the written maps against the CPU's argmax
    where the margin allows. Then the CLI again, warm (its maps held to the
    first run's), and BiSeNet warm at batch 1, 2 and 8: what a batched
    parse would save per image."""
    from fenerf_tpu_torch.apps import prepare_segmaps
    from fenerf_tpu_torch.data import synthetic
    from fenerf_tpu_torch.data.native_loader import read_image
    from fenerf_tpu_torch.nn import bisenet
    from fenerf_tpu_torch.utils.image import read_png, resize

    photos = os.path.join(tmp, "edit_photos")
    os.makedirs(photos)
    face = os.path.join(photos, "render.png")
    zero_counts()
    _render_face(ckpt, dev, face)
    blocks = EDIT_PARSE_SIZE ** 2 // 4096
    render_n = _edit_counts(read_counts(), {
        "film_mlp": 2 * blocks, "ray_resample": blocks,
        "ray_finalize": blocks}, "the 512^2 face render")
    jpg = os.path.join(photos, "photo.jpg")
    os.symlink(synthetic.FIXTURES / sorted(synthetic.fixture_digests())[0],
               jpg)
    weights = os.path.join(tmp, "segNet-20Class.pth")
    sd = bisenet.stand_in_state_dict(0)
    torch.save(sd, weights)
    masks = os.path.join(tmp, "edit_masks")
    zero_counts()
    cli = ["--images", os.path.join(photos, "*"), "--weights", weights,
           "--size", str(EDIT_PARSE_SIZE), "--colorize"]
    res = prepare_segmaps.main(cli + ["--output_dir", masks])
    _edit_counts(read_counts(), {}, "prepare_segmaps")
    n = len(res["files"])
    ms_model = statistics.fmean(res["model_ms"])
    # BiSeNet on the card against the CPU, on the CLI's own inputs
    x = np.stack([resize(read_image(f, "RGB"), (EDIT_PARSE_SIZE,) * 2,
                         "bilinear") for f in res["files"]])
    x = torch.from_numpy(np.ascontiguousarray(
        ((x.astype(np.float32) / 255.0).transpose(0, 3, 1, 2) - 0.5) / 0.5))
    card_params = bisenet.bisenet_from_torch(sd, dev)
    xd = x.to(dev)
    x8 = xd.repeat(4, 1, 1, 1)
    with torch.no_grad():
        ref = bisenet.bisenet_apply(bisenet.bisenet_from_torch(sd), x)
        got = bisenet.bisenet_apply(card_params, xd).cpu()
        # warm, ms per image by batch (the CLI's first call pays cuDNN's
        # first use of every shape): each image alone, both, both x4
        warm = {1: statistics.fmean(time_ms(
            lambda i=i: bisenet.bisenet_apply(card_params, xd[i:i + 1]),
            iters=5) for i in range(n))}
        warm[n] = time_ms(lambda: bisenet.bisenet_apply(card_params, xd),
                          iters=5) / n
        warm[4 * n] = time_ms(lambda: bisenet.bisenet_apply(card_params, x8),
                              iters=5) / (4 * n)
    scale = ref.abs().amax(dim=(1, 2, 3), keepdim=True)
    err = float(((got - ref).abs() / scale).max())
    top = ref.topk(2, dim=1).values
    sure = ((top[:, 0] - top[:, 1]) > BISENET_TOL * scale[:, 0]).numpy()
    want = bisenet.remap_labels(ref.argmax(1).to(torch.uint8).numpy())
    maps = _read_maps(masks, res["files"])
    wrong = int((maps != want)[sure].sum())
    log(f"[edit] parse: {n} images at {EDIT_PARSE_SIZE}^2 in "
        f"{res['seconds']:.2f} s ({res['seconds'] / n * 1e3:.1f} ms per image "
        f"end to end: decode, resize, load, parse, PNGs), BiSeNet "
        f"{ms_model:.2f} ms per {EDIT_PARSE_SIZE}^2 image in the CLI's calls "
        f"(model only, synchronized, batch 1, cold); logits card vs CPU "
        f"max|diff|/max {err:.2e} (tol {BISENET_TOL}); label maps differ at "
        f"{wrong} of {int(sure.sum())} pixels whose margin exceeds it "
        f"({sure.mean():.4f} of all); classes {np.unique(maps).tolist()}")
    if not (err <= BISENET_TOL and wrong == 0 and sure.mean() > 0.99):
        raise AssertionError("BiSeNet on the card differs from the CPU")
    out = os.path.join(tmp, "edit_masks_warm")
    again = prepare_segmaps.main(cli + ["--output_dir", out])
    if (_read_maps(out, again["files"]) != maps)[sure].any():
        raise AssertionError("prepare_segmaps wrote other maps warm")
    log(f"[edit] parse warm: prepare_segmaps {again['seconds'] / n:.4f} s "
        f"per image end to end, BiSeNet "
        f"{statistics.fmean(again['model_ms']):.3f} ms of it (the same "
        f"maps); BiSeNet warm ms per {EDIT_PARSE_SIZE}^2 image (CUDA "
        f"events, mean of 5 calls) at batch 1 / {n} / {4 * n}: "
        f"{warm[1]:.3f} / {warm[n]:.3f} / {warm[4 * n]:.3f}")
    for f in res["files"]:
        stem = os.path.splitext(os.path.basename(f))[0]
        if read_png(os.path.join(masks, f"{stem}_color.png")).shape != (
                EDIT_PARSE_SIZE, EDIT_PARSE_SIZE, 3):
            raise AssertionError(f"bad colorized preview of {stem}")
    return {"photo": jpg, "maps": dict(zip(
        [os.path.splitext(os.path.basename(f))[0] for f in res["files"]],
        maps)), "masks": masks, "ms_bisenet": ms_model,
        "ms_bisenet_warm": warm, "s_per_image": res["seconds"] / n,
        "s_per_image_warm": again["seconds"] / n, "logit_err": err,
        "launches": render_n}


def _edit_masks(parsed, tmp) -> tuple[str, str]:
    """Edit: edit_mask on the photo's map (switch, scale up and down, rect,
    transfer from the render's map, simplify), held to the same ops through
    utils/mask_tools.py; then paint_ui as a user runs it (its own process,
    a free port, --edit_log) over HTTP: /, /labels, /op, /log, /save, the
    saved map equal to apply_op's. -> (the painted map, the edit log)."""
    import subprocess
    import urllib.request

    from fenerf_tpu_torch.apps import edit_mask, paint_ui
    from fenerf_tpu_torch.utils import mask_tools as mt
    from fenerf_tpu_torch.utils.image import read_png

    photo_map = parsed["maps"]["photo"]
    src = os.path.join(parsed["masks"], "photo.png")
    ref = os.path.join(parsed["masks"], "render.png")
    counts = np.bincount(photo_map.ravel(), minlength=19)
    a, b = (int(c) for c in np.argsort(counts)[::-1][:2])
    edited = os.path.join(tmp, "edited.png")
    t0 = time.perf_counter()
    out = edit_mask.main([
        src, edited, "--op", f"switch:{a}:{b}", "--op", f"scale:{a}:1.3",
        "--op", f"scale:{b}:0.7", "--op", "rect:mouth:200:300:312:340",
        "--op", f"transfer:{a}:{ref}:4:-4", "--op", "simplify",
        "--colorize"])
    edit_s = time.perf_counter() - t0
    want = mt.switch_semantic(photo_map, a, b)
    want = mt.scale_semantic(mt.scale_semantic(want, a, 1.3), b, 0.7)
    region = np.zeros(want.shape, bool)
    region[300:340, 200:312] = True
    want = mt.add_semantic(want, mt.LABELS["mouth"], region)
    want = mt.simplify_mask(mt.transfer_semantic(
        want, parsed["maps"]["render"], (a,), (4, -4)))
    if not (np.array_equal(read_png(edited), want)
            and np.array_equal(out, want)):
        raise AssertionError("edit_mask's map differs from mask_tools'")
    changed = float((want != photo_map).mean())
    log(f"[edit] edit_mask: switch {a}<->{b}, scale {a} x1.3, {b} x0.7, "
        f"rect, transfer, simplify in {edit_s:.2f} s; {changed:.3f} of the "
        f"pixels changed, equal to mask_tools'")
    if not 0 < changed < 1:
        raise AssertionError("edit_mask changed nothing or everything")

    painted = os.path.join(tmp, "painted.png")
    log_path = os.path.join(tmp, "sess.editlog.npz")
    root = Path(__file__).resolve().parent
    proc = subprocess.Popen(
        [sys.executable, "-m", "fenerf_tpu_torch.apps.paint_ui", "--mask",
         edited, "--out", painted, "--port", "0", "--edit_log", log_path],
        cwd=root, stdout=subprocess.PIPE, text=True)
    # the server's output, read by a thread (None at its end), so that the
    # wait for its address has a deadline
    lines = queue.Queue()
    reader = threading.Thread(target=lambda: (
        [lines.put(line) for line in proc.stdout], lines.put(None)),
        daemon=True)
    reader.start()
    try:
        port, deadline = None, time.monotonic() + 60
        while port is None:
            try:
                line = lines.get(timeout=max(deadline - time.monotonic(), 0))
            except queue.Empty:
                raise AssertionError("paint_ui printed no address in 60 s")
            if line is None:
                raise AssertionError("paint_ui ended without an address")
            m = re.search(r"http://localhost:(\d+)", line)
            if m:
                port = int(m.group(1))
        base = f"http://127.0.0.1:{port}"

        def post(path, payload):
            req = urllib.request.Request(
                base + path, data=json.dumps(payload).encode(),
                method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.read()

        t0 = time.perf_counter()
        page = _get(base + "/").decode()
        labels = json.loads(_get(base + "/labels"))
        mask = np.asarray(labels["labels"], np.uint8).reshape(
            labels["h"], labels["w"])
        spec = f"scale:{a},1.2"
        d = json.loads(post("/op", {"op": spec,
                                    "labels": mask.ravel().tolist()}))
        opped = np.asarray(d["labels"], np.uint8).reshape(mask.shape)
        post("/log", {"labels": opped.ravel().tolist()})
        msg = post("/save", {"labels": opped.ravel().tolist()}).decode()
        http_s = time.perf_counter() - t0
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        reader.join(timeout=30)
        proc.stdout.close()
    want = paint_ui.apply_op(want, spec)
    with np.load(log_path) as f:
        frames = f["frames"]
    log(f"[edit] paint_ui (pid {proc.pid}, port {port}, exit {rc}): page "
        f"{len(page)} B, /labels {mask.shape}, /op {spec!r}: "
        f"{d['msg']!r}, /save: {msg!r}; edit log {frames.shape}; HTTP "
        f"round trips {http_s * 1e3:.1f} ms")
    if not ("FENeRF mask painter" in page and np.array_equal(mask, out)
            and np.array_equal(opped, want)
            and np.array_equal(read_png(painted), want)
            and frames.shape == (3,) + want.shape
            and np.array_equal(frames[-1], want)
            and np.array_equal(frames[0], out)):
        raise AssertionError("paint_ui's map differs from apply_op's")
    return painted, log_path


def _edit_invert(parsed, painted, inv_ckpt, tmp) -> dict:
    """Invert against the JPEG photo and the edited map on the kernels
    (kernel_train, the ray kernels on), with a 1-frame reconstruction video
    whose RGB panel is the replay's side image; finite losses that fall,
    launches equal to the iterations and the eval renders."""
    from fenerf_tpu_torch.apps import invert
    from fenerf_tpu_torch.utils.image import save_png
    from fenerf_tpu_torch.utils.video import read_avi

    zero_counts()
    res = invert.main(["edit", "--ckpt", inv_ckpt, "--image_path",
                       parsed["photo"], "--seg_path", painted,
                       "--save_dir", os.path.join(tmp, "edit_inv"),
                       "--render_video", "--num_frames", "1", *EDIT_INVERT])
    evals = len(res.mious) + 1   # + the video's frame
    counts = _edit_counts(read_counts(), {
        "film_mlp": EDIT_ITERATIONS + 16 * evals,
        "film_mlp_bwd": EDIT_ITERATIONS, "ray_resample": 8 * evals,
        "ray_finalize": 8 * evals}, "invert")
    first, last = (float(np.mean(x)) for x in (res.losses[:5],
                                               res.losses[-5:]))
    log(f"[edit] invert on the photo and the edited map: "
        f"{len(res.losses)} iterations, loss {res.losses[0]:.5f} -> "
        f"{res.losses[-1]:.5f} (mean of the first 5 {first:.5f}, of the "
        f"last 5 {last:.5f}), mIoU {np.round(res.mious, 4).tolist()}; "
        f"{res.ms_per_iteration:.2f} ms per iteration, {res.ms_per_eval:.2f} "
        f"ms per eval render; launches {counts}")
    if not (np.isfinite(res.losses).all() and last < first):
        raise AssertionError("the edit inversion's losses did not fall")
    frames, _ = read_avi(res.video)
    side = os.path.join(tmp, "inversion.png")
    save_png(side, frames[0][:, :frames.shape[1]])
    return {"side": side, "launches": counts,
            "ms_per_iteration": res.ms_per_iteration,
            "ms_per_eval": res.ms_per_eval}


def _edit_replay(log_path, side, tmp) -> None:
    """Replay: edit_log_video --side the inversion's render; the .avi read
    back equal to log_to_frames."""
    from fenerf_tpu_torch.apps import edit_log_video
    from fenerf_tpu_torch.data.native_loader import read_image
    from fenerf_tpu_torch.utils.video import read_avi

    out = os.path.join(tmp, "replay.avi")
    t0 = time.perf_counter()
    edit_log_video.main(["--log", log_path, "--out", out, "--side", side])
    seconds = time.perf_counter() - t0
    with np.load(log_path) as f:
        want = np.stack(edit_log_video.log_to_frames(
            f["frames"], read_image(side, "RGB")))
    back, fps = read_avi(out)
    log(f"[edit] edit_log_video: {back.shape} at {fps} fps in "
        f"{seconds:.2f} s")
    if not (np.array_equal(back, want) and back.shape[2] == 2 * back.shape[1]):
        raise AssertionError("the replay video differs from log_to_frames")


def _edit_score(ckpt, tmp, dev) -> dict:
    """Score: 2 x EDIT_SCORE_IMAGES renders of the serving checkpoint
    (128^2, random cameras, the kernels) in two directories; eval_metrics
    (fid, kid, isc) between them and of one against itself, stand-in
    InceptionV3 weights on the card."""
    from fenerf_tpu_torch.apps import eval_metrics
    from fenerf_tpu_torch.apps.common import load_generator
    from fenerf_tpu_torch.eval import fid as fidlib
    from fenerf_tpu_torch.models import generator as gen
    from fenerf_tpu_torch.nn import fields, inception
    from fenerf_tpu_torch.ops import film_mlp
    from fenerf_tpu_torch.utils.image import save_png, to_uint8

    _, params, _, cfg, _ = load_generator(ckpt, device=dev)
    params = film_mlp.with_pack(
        fields.with_grid_table(params, cfg, torch.bfloat16), cfg)
    rcfg = gen.RenderConfig(img_size=128, num_steps=48, ray_chunk=4096,
                            fill_mode="seg_padding_background",
                            compute_dtype="bfloat16", backend="kernel")
    g = torch.Generator(device=dev).manual_seed(21)
    dirs = [os.path.join(tmp, f"score_{k}") for k in "ab"]
    zero_counts()
    for d in dirs:
        z = torch.randn(EDIT_SCORE_IMAGES, cfg.z_geo_dim, generator=g,
                        device=dev)
        with torch.no_grad():
            pix = gen.render_from_z(params, cfg, rcfg, z, z, generator=g)
        pix = pix["pixels"][:, -3:].float().cpu().numpy()
        for i, img in enumerate(to_uint8(pix, normalize=False)):
            save_png(os.path.join(d, f"{i:03d}.png"), img.transpose(1, 2, 0))
    blocks = 128 * 128 // 4096 * len(dirs)
    render_n = _edit_counts(read_counts(), {
        "film_mlp": 2 * blocks, "ray_resample": blocks,
        "ray_finalize": blocks}, "the score renders")
    weights = os.path.join(tmp, "inception_edit.npz")
    inception.export_npz(inception.init_inception(
        torch.Generator().manual_seed(0)), weights)
    old = os.environ.get(fidlib.WEIGHTS_ENV)
    os.environ[fidlib.WEIGHTS_ENV] = weights
    try:
        zero_counts()
        t0 = time.perf_counter()
        pair = eval_metrics.main(["--real_dir", dirs[0], "--gen_dir",
                                  dirs[1], "--metrics", "fid", "kid", "isc"])
        pair_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self_ = eval_metrics.main(["--real_dir", dirs[0], "--gen_dir",
                                   dirs[0], "--metrics", "fid", "kid"])
        self_s = time.perf_counter() - t0
        _edit_counts(read_counts(), {}, "eval_metrics")
    finally:
        if old is None:
            os.environ.pop(fidlib.WEIGHTS_ENV, None)
        else:
            os.environ[fidlib.WEIGHTS_ENV] = old
    log(f"[edit] eval_metrics ({EDIT_SCORE_IMAGES} vs {EDIT_SCORE_IMAGES} "
        f"renders, stand-in Inception): {json.dumps(pair)} in {pair_s:.2f} s; "
        f"a directory against itself: fid {self_['fid']:.3e}, kid mean "
        f"{self_['kid_mean']:.3e} (below {EDIT_FID_SELF} / {EDIT_KID_SELF}) "
        f"in {self_s:.2f} s")
    if not (all(math.isfinite(v) for v in pair.values())
            and abs(self_["fid"]) < EDIT_FID_SELF
            and abs(self_["kid_mean"]) < EDIT_KID_SELF):
        raise AssertionError(f"eval_metrics: {pair}, {self_}")
    return {"metrics_s": pair_s, "launches": render_n}


def _hd_params(dev):
    """SPATIALSIRENSEMANTICHD at its published widths (hidden 256, z 256;
    64 label and 64 RGB feature channels), random weights (seed 5), sigma
    bias SIGMA_BIAS, with stand-in neural-renderer heads (64^2 -> 256^2:
    RGB, and 19 label channels without the final sigmoid) -> (cfg, params,
    {"nr_img" / "nr_seg": (params, NeuralRendererConfig)})."""
    from fenerf_tpu_torch.nn import fields
    from fenerf_tpu_torch.nn import neural_renderer as nr

    cfg = fields.get_config(HD)
    params = fields.init_field(torch.Generator(device=dev).manual_seed(5),
                               cfg, device=dev)
    params["sigma_head"]["b"] = params["sigma_head"]["b"] + SIGMA_BIAS
    heads = {}
    for key, out_dim, act in (("nr_img", 3, True), ("nr_seg", 19, False)):
        ncfg = nr.NeuralRendererConfig(n_feat=64, input_dim=64,
                                       out_dim=out_dim, final_actvn=act,
                                       img_size=HD_SIZE,
                                       input_size=HD_FEATURES)
        heads[key] = (nr.init_neural_renderer(
            torch.Generator().manual_seed(out_dim), ncfg), ncfg)
    return cfg, params, heads


def write_hd_checkpoint(dev, tmp) -> str:
    """_hd_params as a generator .npz with its heads."""
    from fenerf_tpu_torch.apps.common import save_generator

    cfg, params, heads = _hd_params(dev)
    ckpt = os.path.join(tmp, "generator_hd.npz")
    save_generator(ckpt, params, params, params, HD, step=0,
                   neural_renderers=heads)
    log(f"[edit] wrote {HD} checkpoint (output {cfg.output_dim}, hidden "
        f"{cfg.hidden_dim}) with nr_img / nr_seg heads "
        f"({os.path.getsize(ckpt) / 2**20:.0f} MiB)")
    return ckpt


def _edit_hd(tmp, dev) -> dict:
    """HD: render_multiview --hd on the HD checkpoint (two sheets, the
    second timed warm), the field kernel and the ray kernels on; one view's
    features on the field kernel against the field's torch route at bf16
    (RENDER_TOL), and the heads on the card against the CPU at f32
    (NR_TOL)."""
    from fenerf_tpu_torch.apps import render_multiview
    from fenerf_tpu_torch.apps.common import load_neural_renderers
    from fenerf_tpu_torch.compat.jax_bridge import tree_map
    from fenerf_tpu_torch.models import generator as gen
    from fenerf_tpu_torch.nn.neural_renderer import apply_neural_renderer
    from fenerf_tpu_torch.utils.image import read_png

    ckpt = write_hd_checkpoint(dev, tmp)
    d = os.path.join(tmp, "multiview_hd")
    zero_counts()
    sheets = render_multiview.main(["--ckpt", ckpt, "--hd", "--image_size",
                                    str(HD_SIZE), "--seeds",
                                    *MULTIVIEW_SEEDS, "--output_dir", d])
    blocks = 5 * len(sheets) * (HD_FEATURES ** 2 // 4096)
    counts = _edit_counts(read_counts(), {
        "film_mlp": 2 * blocks, "ray_resample": blocks,
        "ray_finalize": blocks}, "render_multiview --hd")
    size = (HD_SIZE + 4, 5 * (HD_SIZE + 2) + 2, 3)
    for seed, v, _ in sheets:
        if not (v.shape == (5, 22, HD_SIZE, HD_SIZE)
                and np.isfinite(v).all()):
            raise AssertionError(f"bad HD views {v.shape}")
        for kind in ("img", "seg"):
            if read_png(os.path.join(d, f"{kind}_{seed}.png")).shape != size:
                raise AssertionError(f"HD {kind}_{seed}.png")
    # one view's features: field kernel vs the field's torch route (bf16),
    # the CLI's settings, films and draws, the ray kernels off on both
    params, cfg, fg, fa = _app_films(ckpt, int(MULTIVIEW_SEEDS[0]), dev, 0.7)
    feats = {}
    for backend in ("kernel", "torch"):
        rcfg = gen.RenderConfig(img_size=HD_FEATURES, num_steps=48,
                                fill_mode=None, ray_chunk=4096,
                                compute_dtype="bfloat16", backend=backend)
        with ray_kernels("never"), torch.no_grad():
            feats[backend] = gen.render(
                params, cfg, rcfg, fg, fa, 1,
                camera=(math.pi / 2, math.pi / 2, 12.0),
                generator=torch.Generator(device=dev).manual_seed(0))[
                    "pixels"].float()
    field_err = float((feats["kernel"] - feats["torch"]).abs().max())
    # the heads on the card against the CPU, on the kernel's features
    nrs = load_neural_renderers(ckpt, device=dev)
    x = (feats["kernel"] + 1.0) * 0.5
    nr_err = 0.0
    for key, sl in (("nr_seg", slice(0, 64)), ("nr_img", slice(64, 128))):
        p, ncfg = nrs[key]
        with torch.no_grad():
            got = apply_neural_renderer(p, ncfg, x[:, sl]).cpu()
            ref = apply_neural_renderer(tree_map(lambda t: t.cpu(), p), ncfg,
                                        x[:, sl].cpu())
        nr_err = max(nr_err, float((got - ref).abs().max()
                                   / ref.abs().max()))
    log(f"[edit] render_multiview --hd ({HD_FEATURES}^2 features x 48 + 48 "
        f"steps -> {HD_SIZE}^2): {sheets[1][2]:.1f} ms per 5-view HD sheet "
        f"(first {sheets[0][2]:.1f}); launches {counts}; one view's "
        f"features, max|field kernel - torch field route (bf16)| "
        f"{field_err:.3e} (tol {RENDER_TOL}); the heads card vs CPU "
        f"max|diff|/max {nr_err:.2e} (tol {NR_TOL})")
    if not (field_err <= RENDER_TOL and nr_err <= NR_TOL):
        raise AssertionError(f"HD: field {field_err}, heads {nr_err}")
    return {"ms_per_sheet": sheets[1][2], "launches": counts,
            "field_err": field_err, "nr_err": nr_err}


def phase_edit_loop(ckpt, inv_ckpt, tmp, dev) -> dict:
    """5g, the editing workflow's mask half on the card: parse, edit and
    paint, invert, replay, score, HD (the helpers above), the ray kernels
    on. Returns its numbers and its launches (the face and score renders,
    the inversion and the HD sheets)."""
    t0 = time.perf_counter()
    with ray_kernels("auto"):
        parsed = _edit_parse(ckpt, tmp, dev)
        painted, log_path = _edit_masks(parsed, tmp)
        inverted = _edit_invert(parsed, painted, inv_ckpt, tmp)
        _edit_replay(log_path, inverted["side"], tmp)
        scored = _edit_score(ckpt, tmp, dev)
        hd = _edit_hd(tmp, dev)
    parts = (parsed, inverted, scored, hd)
    launches = {k: sum(p["launches"].get(k, 0) for p in parts)
                for k in parsed["launches"]}
    seconds = time.perf_counter() - t0
    log(f"[edit] the edit loop in {seconds:.1f} s on {card()}: BiSeNet "
        f"{parsed['ms_bisenet']:.2f} ms per {EDIT_PARSE_SIZE}^2 image in "
        f"the CLI (cold), {parsed['ms_bisenet_warm'][1]:.3f} warm, "
        f"prepare_segmaps {parsed['s_per_image']:.3f} s per image (cold), "
        f"{parsed['s_per_image_warm']:.4f} warm, invert "
        f"{inverted['ms_per_iteration']:.2f} ms per iteration, HD sheet "
        f"{hd['ms_per_sheet']:.1f} ms, eval_metrics {scored['metrics_s']:.2f} "
        f"s; launches {launches}")
    return {"launches": launches, "seconds": seconds,
            "ms_bisenet": parsed["ms_bisenet"],
            "ms_bisenet_warm": parsed["ms_bisenet_warm"],
            "s_per_image": parsed["s_per_image"],
            "ms_per_iteration": inverted["ms_per_iteration"],
            "ms_per_hd_sheet": hd["ms_per_sheet"]}


# ---------------------------------------------------------------------------
# the latent-grid family's training: CelebA_latent_grid stage 0 at full
# width (SPATIALSIRENGRID at its published widths; bs 48, split 16, 64^2,
# 12 + 12 steps). No kernel is on its path: the JAX trainer runs this
# family on XLA alone, field and ray machinery
# ---------------------------------------------------------------------------

GRID_CURRICULUM = "CelebA_latent_grid"
GRID_TRAIN_STEPS = 3   # the first is warm-up; ms/step is over the rest
# the field's VJP on the card against the CPU: GRID_VJP_RAYS rays of one G
# microbatch, per parameter group, phase 9's criterion
GRID_VJP_RAYS = 64
# the latent plane, card against the CPU, relative to its largest value:
# f32 convolutions with TF32 off, another order
GRID_PLANE_TOL = 1e-4
# the trainer's CLI on the committed fixture JPEGs in turn as a CelebA jpg
# glob of one batch (48): 2 steps with a checkpoint, a sample event and a
# small FID block at step 2, then a 1-step resume
GRID_CLI_IMAGES = 48
GRID_CLI = ["--curriculum", GRID_CURRICULUM, "--log_every", "1"]
GRID_CLI_FIRST = ["--total_steps", "2", "--model_save_interval", "2",
                  "--sample_interval", "2", "--eval_freq", "2",
                  "--num_eval_imgs", "64", "--num_real_imgs", "64"]
GRID_CLI_RESUMED = ["--total_steps", "3", "--model_save_interval", "0",
                    "--sample_interval", "0", "--eval_freq", "0"]
# the profiled step's device time by the part of the model a kernel's op
# runs for (record_function labels around the port's functions, the
# backward attributed through its forward op)
GRID_PARTS = (("fenerf.plane", "compute_plane", "plane convolutions"),
              ("fenerf.sampling", "sample_local_latents", "plane sampling"),
              ("fenerf.mapping", "point_mapping", "per-point mapping"),
              ("fenerf.field", "apply_grid_field", None))


@contextlib.contextmanager
def _labelled_parts():
    """record_function labels around the grid field's parts
    (nn/latent_grid_field.py) and the critics (nn/discriminators.py) for
    the block; the functions are restored after it."""
    from fenerf_tpu_torch.nn import discriminators as disc
    from fenerf_tpu_torch.nn import latent_grid_field as lgf

    def label(fn, name):
        def run(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return run

    parts = [(lgf, attr, lab) for lab, attr, _ in GRID_PARTS]
    parts.append((disc, "apply_discriminator", "fenerf.critic"))
    kept = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in parts]
    try:
        for mod, attr, lab in parts:
            setattr(mod, attr, label(getattr(mod, attr), lab))
        yield
    finally:
        for mod, attr, fn in kept:
            setattr(mod, attr, fn)


def _device_ms_by_label(prof, labels) -> dict:
    """Device ms of a trace by (label, kernel name): a kernel takes the
    record_function label nearest above the op that launched it; an op in
    a backward node takes the label of the forward op that made the node
    (the node's sequence number on its forward thread, as torch's own
    backward stack traces link them; the R1 term's double backward is one
    more such step). Unlabelled kernels go under None."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]

    def backward_node(e):
        return (e.scope == 1 or e.name.startswith(
            "autograd::engine::evaluate_function")) and e.sequence_nr >= 0

    made = {}   # (thread, number) -> the last op with it, the node's maker
    for e in sorted(events, key=lambda e: e.time_range.start):
        if e.sequence_nr >= 0 and not backward_node(e):
            made[(e.thread, e.sequence_nr)] = e
    memo = {}

    def label(e, depth=0):
        if id(e) not in memo:
            out, x = None, e
            while x is not None:
                if x.name in labels:
                    out = x.name
                    break
                if backward_node(x):
                    maker = made.get((x.fwd_thread, x.sequence_nr))
                    if maker is not None and depth < 8:
                        out = label(maker, depth + 1)
                    break
                x = x.cpu_parent
            memo[id(e)] = out
        return memo[id(e)]

    totals = {}
    for e in events:
        for k in e.kernels:
            key = (label(e), k.name)
            totals[key] = totals.get(key, 0.0) + k.duration / 1e3
    return totals


def _grid_step_groups(by_label) -> dict:
    """The profiled step's device ms by group: the plane's convolutions,
    its sampling, the per-point mapping, the FiLM layers' products and
    their epilogue / sine, the critics with R1, and the rest (the ray
    machinery, compositing, losses, optimizers, EMA)."""
    names = {lab: name for lab, _, name in GRID_PARTS if name}
    names["fenerf.critic"] = "critics with R1"
    out = {}
    for (lab, kernel), ms in by_label.items():
        if lab == "fenerf.field":
            group = ("FiLM products" if "gemm" in kernel.lower()
                     else "FiLM epilogue / sine")
        else:
            group = names.get(lab, "rest")
        out[group] = out.get(group, 0.0) + ms
    return out


def _grid_field_vjp(params, cfg, pts, dirs, z, ct):
    """The grid field's VJP w.r.t. every parameter (the plane computed from
    z inside it) -> ({group: flat gradient}, the plane)."""
    from fenerf_tpu_torch.compat.jax_bridge import tree_leaves, tree_map
    from fenerf_tpu_torch.nn import latent_grid_field as lgf

    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    out = lgf.apply_grid_field(p, cfg, pts, dirs, z)
    groups = sorted(p)
    leaves = [tree_leaves(p[k]) for k in groups]
    grads = torch.autograd.grad(out, [t for ls in leaves for t in ls], ct)
    flat, i = {}, 0
    for k, ls in zip(groups, leaves):
        flat[k] = torch.cat([g.flatten() for g in grads[i:i + len(ls)]])
        i += len(ls)
    with torch.no_grad():
        plane = lgf.compute_plane(p, cfg, z)
    return flat, plane


def _grid_vjp_check(state, meta, dev) -> dict:
    """GRID_VJP_RAYS rays of one G microbatch (its z, points along the
    stage's rays at the stage's depths, its ray directions): the field's
    VJP on the card against the same on the CPU, per parameter group
    (cosine, norms), and the latent plane against the CPU's. The card
    runs with cuDNN's TF32 at torch's default (on): the plane's
    convolutions must pin it off themselves, forward and backward."""
    from fenerf_tpu_torch.compat.jax_bridge import tree_map
    from fenerf_tpu_torch.core import rays as raylib

    cfg = meta.field_config()
    b = meta.batch_size // meta.batch_split
    g = torch.Generator().manual_seed(13)
    z = torch.randn(b, cfg.z_dim, generator=g)
    rcfg = meta.render_config()
    dirs_cam = raylib.pixel_ray_dirs(rcfg.img_size, rcfg.fov, "cpu")
    pick = torch.randperm(dirs_cam.shape[0], generator=g)[:GRID_VJP_RAYS]
    z0 = raylib.initial_z_vals(rcfg.num_steps, rcfg.ray_start,
                               rcfg.ray_end, "cpu")
    tr = raylib.transform_rays(
        b, dirs_cam[pick], z0, rcfg.h_stddev, rcfg.v_stddev, rcfg.h_mean,
        rcfg.v_mean, mode=rcfg.sample_dist,
        jitter=torch.rand(b, GRID_VJP_RAYS, rcfg.num_steps, generator=g),
        cam_h=torch.randn(b, 1, generator=g),
        cam_v=torch.randn(b, 1, generator=g))
    pts = (tr.ray_origins[:, :, None] + tr.ray_dirs[:, :, None]
           * tr.z_vals[..., None]).reshape(b, -1, 3)
    dirs = tr.ray_dirs[:, :, None].expand(
        b, GRID_VJP_RAYS, rcfg.num_steps, 3).reshape(b, -1, 3)
    ct = torch.randn(pts.shape[:2] + (cfg.output_dim,), generator=g)
    cpu_params = tree_map(lambda t: t.detach().cpu(), state.g_params)
    ref, plane_ref = _grid_field_vjp(cpu_params, cfg, pts, dirs, z, ct)
    to = lambda t: t.to(dev)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=True):
        got, plane = _grid_field_vjp(state.g_params, cfg, to(pts),
                                     to(dirs), to(z), to(ct))
    cos, norm, n = _grad_compare([got[k].cpu() for k in sorted(ref)],
                                 [ref[k] for k in sorted(ref)])
    plane_err = float((plane.cpu() - plane_ref).abs().max()
                      / plane_ref.abs().max())
    log(f"[grid train] the field's VJP on {b} x {GRID_VJP_RAYS} rays x "
        f"{rcfg.num_steps} samples, card (cuDNN TF32 allowed by the "
        f"process) vs CPU, {n} groups: worst cosine {cos:.6f}, worst norm "
        f"difference {norm:.2e} (tol > {GRAD_COS}, < {GRAD_NORM}); the latent "
        f"plane max|diff|/max|cpu| {plane_err:.2e} (tol {GRID_PLANE_TOL})")
    if not (n == len(ref) and cos > GRAD_COS and norm < GRAD_NORM
            and plane_err <= GRID_PLANE_TOL):
        raise AssertionError("the grid field's VJP or plane on the card "
                             "differs from the CPU's")
    return {"vjp_cos": cos, "vjp_norm": norm, "plane_err": plane_err}


def phase_grid_train(dev) -> dict:
    """The latent-grid family's training at full width: GRID_TRAIN_STEPS
    train_step calls of CelebA_latent_grid's stage 0 on seeded synthetic
    reals, the ray switch on (FENERF_RAY_KERNELS=auto), and no kernel
    launched; finite losses; every G group and the EMA moved; ms/step,
    images/s, peak device memory; one more step under torch.profiler,
    its device time by group; the field's VJP card vs CPU
    (_grid_vjp_check); then the trainer's CLI (_grid_train_cli). Returns
    the numbers it printed and the launches of each run (none)."""
    from torch.profiler import ProfilerActivity, profile

    from fenerf_tpu_torch.compat.jax_bridge import tree_leaves
    from fenerf_tpu_torch.train import loop
    from fenerf_tpu_torch.train.curriculum import CURRICULA

    cur = CURRICULA[GRID_CURRICULUM]
    meta = cur.at_step(0)
    cfg = meta.field_config()
    b, size = meta.batch_size, meta.img_size
    tag = "[grid train]"
    torch.cuda.empty_cache()
    state = loop.init_train_state(meta, seed=0, device=dev)
    before = {k: [t.clone() for t in tree_leaves(v)]
              for k, v in state.g_params.items()}
    ema0 = [t.clone() for t in tree_leaves(state.ema.params)]
    gen = torch.Generator(device=dev).manual_seed(17)
    as_t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    no_labels = torch.zeros(b, 0, size, size, device=dev)

    def step(state, i):
        imgs, _ = _synthetic_reals(gen, b, size, dev)
        scal = loop.StepScalars(alpha=as_t(cur.alpha(i)),
                                noise_std=as_t(meta.nerf_noise(i)),
                                topk_frac=as_t(meta.topk_fraction(i)))
        return loop.train_step(state, imgs, no_labels, scal, meta,
                               generator=gen)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    with ray_kernels("auto"):
        # --- the main path: counts from zero ---
        zero_counts()
        for i in range(GRID_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses = {k: float(m[k]) for k in ("d_img_loss", "g_loss",
                                               "fake_opacity")}
            log(f"{tag} step {i}: " + " ".join(
                f"{k} {v:.5f}" for k, v in losses.items())
                + f" ({times[-1] * 1e3:.1f} ms)")
            if not all(math.isfinite(v) for v in losses.values()):
                raise AssertionError(f"non-finite loss at step {i}")
        counts, plain = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = statistics.median(times[1:]) * 1e3
    log(f"{tag} {GRID_CURRICULUM} stage 0, {GRID} at its published widths "
        f"(z {cfg.z_dim}, hidden {cfg.hidden_dim}, plane {cfg.grid_ch} x "
        f"{cfg.grid_res}^2, ch_max {cfg.ch_max}; bs {b}, split "
        f"{meta.batch_split}, {size}^2, {meta.num_steps}+{meta.num_steps} "
        f"steps): {ms:.1f} ms/step (host clock, synchronized; median of "
        f"steps 2-{GRID_TRAIN_STEPS}, range {min(times[1:]) * 1e3:.1f}-"
        f"{max(times[1:]) * 1e3:.1f}; the first {times[0] * 1e3:.1f}), "
        f"{b / ms * 1e3:.2f} images/s; peak device memory {peak:.2f} GiB; "
        f"launches {counts}, plain-version calls {plain}")
    if any(counts.values()) or plain:
        raise AssertionError("the grid trainer launched a kernel: its path "
                             "has none (the JAX trainer's is XLA alone)")
    for k, ts in before.items():
        if not any(not torch.equal(x, y) for x, y in
                   zip(ts, tree_leaves(state.g_params[k]))):
            raise AssertionError(f"G's {k} did not move")
    if not any(not torch.equal(x, y) for x, y in
               zip(ema0, tree_leaves(state.ema.params))):
        raise AssertionError("the EMA did not move")
    log(f"{tag} every G group moved ({', '.join(sorted(before))}) and the "
        f"EMA")

    labels = {lab for lab, _, _ in GRID_PARTS} | {"fenerf.critic"}
    with _labelled_parts(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, GRID_TRAIN_STEPS)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    groups = _grid_step_groups(_device_ms_by_label(prof, labels))
    total = sum(groups.values())
    log(f"{tag} one profiled step: device time {total:.1f} ms, busy share "
        f"{total / ms:.3f} of the median step; by group: " + ", ".join(
            f"{k} {v:.1f} ms ({v / max(total, 1e-9):.1%})" for k, v in
            sorted(groups.items(), key=lambda kv: -kv[1]))
        + f" (grouped in {time.perf_counter() - t0:.1f} s)")
    results = {"ms_per_step": ms, "imgs_per_s": b / ms * 1e3,
               "peak_gib": peak, "device_ms": total, "groups": groups,
               "launches": {"steps": counts}}
    del prof
    results.update(_grid_vjp_check(state, meta, dev))
    del state
    torch.cuda.empty_cache()
    results["launches"].update(_grid_train_cli(dev, cfg, results))
    return results


def _grid_train_cli(dev, cfg, results) -> dict:
    """The trainer's CLI on the fixture JPEGs in turn as a CelebA glob of
    one batch: 2 steps with a checkpoint, RGB samples and the FID block at
    step 2, then a 1-step resume, the ray switch on. Checks no kernel
    launched, the torch routes named, the logged steps, finite losses, the
    sheets, the grid generator.npz and a finite FID; adds its numbers to
    `results`. Returns the launches of each run."""
    from fenerf_tpu_torch.apps import train as train_cli
    from fenerf_tpu_torch.apps.common import load_generator
    from fenerf_tpu_torch.data import synthetic
    from fenerf_tpu_torch.eval import fid as fidlib
    from fenerf_tpu_torch.nn import inception

    tag = "[grid train]"
    launches = {}
    digests = synthetic.fixture_digests()
    old_weights = os.environ.get(fidlib.WEIGHTS_ENV)
    with tempfile.TemporaryDirectory() as tmp:
        images = os.path.join(tmp, "celeba")
        os.makedirs(images)
        for i in range(GRID_CLI_IMAGES):
            name = sorted(digests)[i % len(digests)]
            os.symlink(synthetic.FIXTURES / name,
                       os.path.join(images, f"{i:05d}.jpg"))
        weights = os.path.join(tmp, "inception.npz")
        inception.export_npz(inception.init_inception(
            torch.Generator().manual_seed(0)), weights)
        os.environ[fidlib.WEIGHTS_ENV] = weights
        out = os.path.join(tmp, "run")
        args = GRID_CLI + ["--device", dev.type, "--data_root",
                           os.path.join(images, "*.jpg"), "--output_dir",
                           out]
        try:
            for run, extra in (("first", GRID_CLI_FIRST),
                               ("resumed", GRID_CLI_RESUMED
                                + ["--load_dir", out])):
                tee = _Tee(sys.stdout)
                zero_counts()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                with ray_kernels("auto"), contextlib.redirect_stdout(tee):
                    train_cli.main(args + extra)
                seconds = time.perf_counter() - t0
                counts, plain = read_counts()
                launches[f"cli {run}"] = counts
                text = "".join(tee.lines)
                log(f"{tag} CLI {run}: {seconds:.1f} s, launches {counts}, "
                    f"plain-version calls {plain}, peak device memory "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
                if any(counts.values()) or plain:
                    raise AssertionError(f"the grid CLI ({run}) launched a "
                                         f"kernel")
                if "field torch, rays torch" not in text:
                    raise AssertionError("the CLI's [stage] line does not "
                                         "name the torch routes")
                results[f"cli_{run}_s"] = seconds
                if run == "first":
                    eval_text = text
            with open(os.path.join(out, "metrics.jsonl")) as f:
                lines = [json.loads(x) for x in f]
            if [x["step"] for x in lines] != [0, 1, 2] \
                    or "at step 2" not in text:
                raise AssertionError(f"the grid CLI logged steps "
                                     f"{[x['step'] for x in lines]}")
            for x in lines:
                if not all(math.isfinite(x[k]) for k in ("d_img_loss",
                                                         "g_loss")):
                    raise AssertionError(f"grid CLI: non-finite loss {x}")
                log(f"{tag} CLI step {x['step']}: d_img_loss "
                    f"{x['d_img_loss']:.4f} g_loss {x['g_loss']:.4f}, step "
                    f"{x['step_ms']:.1f} ms, loader {x['loader_ms']:.1f} ms "
                    f"per batch, peak {x.get('peak_hbm_gb')} GiB")
            sheets = sorted(n for n in os.listdir(out) if n.endswith(".png"))
            if len(sheets) != 5 or any("_seg_" in n for n in sheets):
                raise AssertionError(f"grid CLI sample sheets: {sheets}")
            _, ema, _, gcfg, config = load_generator(
                os.path.join(out, "generator.npz"), device=dev)
            if config["family"] != "grid" or gcfg != cfg \
                    or config["step"] != 2:
                raise AssertionError(f"grid generator.npz: {config}")
            with open(os.path.join(out, "fid.txt")) as f:
                fid = float(f.read().strip().split(":")[-1])
            if not math.isfinite(fid):
                raise AssertionError(f"fid.txt holds {fid}")
            m_eval = re.search(r"\[eval-t\] output_images_s=([0-9.]+) "
                               r"images=(\d+)", eval_text)
            render_ms = float(m_eval.group(1)) * 1e3 / int(m_eval.group(2))
            log(f"{tag} CLI: generator.npz (family grid, step 2) loads on "
                f"the card, {len(sheets)} RGB sample sheets, FID at step 2 "
                f"(stand-in weights) {fid:.4f}, {render_ms:.1f} ms per "
                f"rendered 128^2 EMA image ({m_eval.group(2)})")
            results["cli_steps_ms"] = [x["step_ms"] for x in lines]
            results["fid_render_ms"] = render_ms
        finally:
            if old_weights is None:
                os.environ.pop(fidlib.WEIGHTS_ENV, None)
            else:
                os.environ[fidlib.WEIGHTS_ENV] = old_weights
    return launches




# ---------------------------------------------------------------------------
# 11. ddp: the data-parallel step, the multi-process CLI and the supervisor
# ---------------------------------------------------------------------------

DDP_STEPS = 2
DDP_TOPK = 0.6      # forced, so that each chunk's kept set spans the ranks
# the two ranks against one process on the global batch: only the order of
# the reductions differs. The JAX package's test_mesh_size_invariance bounds:
# the first step's losses 1e-3 (absolute) and the G parameters after both
# steps 5e-4. The second step's losses are computed on parameters that
# already differ: Adam's first update (beta1 0) is lr * sign(g), so a
# gradient element within a few ulps of 0 moves by +-lr on one side and -+lr
# on the other; over two steps at G's lr 6e-5 that reaches at most
# (2 + 2 sqrt(1.9)) lr = 2.86e-4 per parameter. Beside them the witness, one process against itself with
# only the reduction order changed (full_batch on the same draws), shows how
# far that alone carries the second step; its losses reach hundreds at full
# width, so the second step is held relative to the loss (|loss| >= 1)
DDP_LOSS_TOL = 1e-3
DDP_LOSS2_TOL = 2e-3
DDP_PARAM_TOL = 5e-4
DDP_CLI_PAIRS = 24          # one stage-0 batch
DDP_SUPERVISED_STEPS = 4    # the supervised run resumes at 3 and ends at 4
DDP_KILL_AT = 3             # killed once its metrics show this step


def _ddp_inputs(meta, dev):
    """The global batch of the ddp phase's steps (seeded)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    return _synthetic_reals(gen, 2 * meta.batch_size, meta.img_size, dev)


def _ddp_scalars(cur, meta, step, dev):
    from fenerf_tpu_torch.train import loop

    as_t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    return loop.StepScalars(alpha=as_t(cur.alpha(step)),
                            noise_std=as_t(meta.nerf_noise(step)),
                            topk_frac=as_t(DDP_TOPK))


def _ddp_step_generator(dev, step):
    return torch.Generator(device=dev).manual_seed(1000 + step)


def _full_batch_draws(draws):
    """A split step's draws as one render per phase (each RenderDraws
    joined on its batch axis): the same random numbers for meta.full_batch,
    which computes the same split objective in another reduction order."""
    from fenerf_tpu_torch.models.generator import RayNoise, RenderDraws

    cat = lambda ts: None if ts[0] is None else torch.cat(ts)

    def join(rs):
        if rs is None:
            return None
        if any(r.ray_perm is not None or r.cam_coin is not None for r in rs):
            raise AssertionError("[ddp] the witness joins no grad_rays / "
                                 "hybrid draws")
        return [RenderDraws(cat([r.jitter for r in rs]),
                            cat([r.cam_h for r in rs]),
                            cat([r.cam_v for r in rs]),
                            RayNoise(*(cat([r.noise[i] for r in rs])
                                       for i in range(3))))]

    if draws.aug_d is not None:
        raise AssertionError("[ddp] the witness joins no DiffAugment draws")
    return draws._replace(fakes_img=join(draws.fakes_img),
                          fakes_seg=join(draws.fakes_seg),
                          g_renders=join(draws.g_renders))


def _ddp_rank(rank: int, port: int, out: str) -> None:
    """One of two gloo ranks on cuda:0 (a spawned process): the flagship's
    stage 0 (24 per rank, 48 global, split 4) for DDP_STEPS steps with the
    ray kernels on, through train/sharding.py::train_step_sharded; writes
    its losses, times, all-reduce traffic, peak memory, launches, the
    replica check and (rank 0) the updated G to `out`."""
    from fenerf_tpu_torch.compat.jax_bridge import tree_leaves
    from fenerf_tpu_torch.train import loop, sharding
    from fenerf_tpu_torch.train.curriculum import CURRICULA

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["FENERF_RAY_KERNELS"] = "auto"
    dev = torch.device("cuda", 0)
    base = sharding.init_distributed(f"127.0.0.1:{port}", 2, rank,
                                     backend="gloo", device=dev)
    traffic = {"ms": 0.0, "bytes": 0, "calls": 0}

    class Timed(sharding.Group):
        """The group's all-reduce timed (synchronized) and its bytes
        counted."""

        def all_reduce(self, t, op=torch.distributed.ReduceOp.SUM):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().all_reduce(t, op)
            torch.cuda.synchronize()
            traffic["ms"] += (time.perf_counter() - t0) * 1e3
            traffic["bytes"] += t.numel() * t.element_size()
            traffic["calls"] += 1
            return t

    group = Timed(base.rank, base.world, base.device, base.host)
    cur = CURRICULA[TEXTURE]
    meta = cur.at_step(0)
    state = loop.init_train_state(meta, seed=0, device=dev)
    sharding.replicate(group, state)
    imgs, labels = sharding.shard_batch(group, *_ddp_inputs(meta, dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = {"steps": []}
    zero_counts()
    for step in range(DDP_STEPS):
        for k in traffic:
            traffic[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = sharding.train_step_sharded(
            state, imgs, labels, _ddp_scalars(cur, meta, step, dev), meta,
            group, generator=_ddp_step_generator(dev, step))
        torch.cuda.synchronize()
        res["steps"].append({
            "ms": (time.perf_counter() - t0) * 1e3,
            "losses": {k: float(v) for k, v in m.items()},
            "allreduce_ms": traffic["ms"],
            "allreduce_bytes": traffic["bytes"],
            "allreduce_calls": traffic["calls"]})
    res["counts"], res["plain"] = read_counts()
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    try:
        sharding.check_replica_consistency(group, state)
        res["replicas"] = "bit-identical"
    except AssertionError as e:
        res["replicas"] = str(e)
    if rank == 0:
        res["g"] = torch.cat([t.detach().reshape(-1).float().cpu()
                              for t in tree_leaves(state.g_params)])
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    sharding.host_barrier(group, "ddp_done")
    sharding.shutdown()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ddp_two_ranks(dev, tmp) -> dict:
    """(i): two gloo ranks on cuda:0 against one process on the global
    batch."""
    import multiprocessing

    from fenerf_tpu_torch.compat.jax_bridge import tree_leaves
    from fenerf_tpu_torch.train import loop
    from fenerf_tpu_torch.train.curriculum import CURRICULA

    out = os.path.join(tmp, "ddp")
    os.makedirs(out)
    port = _free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_ddp_rank, args=(r, port, out))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0, 0]:
        raise AssertionError(f"[ddp] the ranks exited with {codes}")
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    # the same steps in this process on the 48-image global batch, split 4
    # (the reference), and again in one full-batch pass on the same draws
    # (the witness: only the order of the reductions differs)
    import dataclasses

    cur = CURRICULA[TEXTURE]
    meta = cur.at_step(0)
    imgs, labels = _ddp_inputs(meta, dev)
    runs = {}
    with ray_kernels("auto"):
        for name, full in (("one", False), ("witness", True)):
            state = loop.init_train_state(meta, seed=0, device=dev)
            m_run = dataclasses.replace(meta, full_batch=full)
            losses = []
            for step in range(DDP_STEPS):
                scal = _ddp_scalars(cur, meta, step, dev)
                draws = loop.make_step_draws(
                    _ddp_step_generator(dev, step), meta, imgs.shape[0],
                    scal.noise_std, dev)
                state, m = loop.train_step(
                    state, imgs, labels, scal, m_run,
                    draws=_full_batch_draws(draws) if full else draws)
                losses.append({k: float(v) for k, v in m.items()})
            runs[name] = (losses, torch.cat([
                t.detach().reshape(-1).float().cpu()
                for t in tree_leaves(state.g_params)]))
            del state
    one, g = runs["one"]

    def gaps(others):
        """Per step, the largest difference of a loss from the reference's
        over its scale (1 at the first step: absolute; max(1, |loss|)
        after it: relative), and the loss it is of."""
        return [max((abs(o[s][k] - one[s][k])
                     / (1.0 if s == 0 else max(1.0, abs(one[s][k]))), k)
                    for o in others for k in one[s])
                for s in range(DDP_STEPS)]

    loss_gaps = gaps([[st["losses"] for st in r["steps"]] for r in ranks])
    witness_gaps = gaps([runs["witness"][0]])
    loss_err = [x for x, _ in loss_gaps]
    witness_err = [x for x, _ in witness_gaps]
    param_err = float((ranks[0]["g"] - g).abs().max())
    witness_param = float((runs["witness"][1] - g).abs().max())
    renders = 3 * meta.batch_split
    want = {"film_mlp": 2 * renders, "film_mlp_bwd": 2 * meta.batch_split,
            "ray_resample": renders, "ray_finalize": renders,
            "fold_zexp": 1}
    want = {k: want.get(k, 0) * DDP_STEPS for k in ranks[0]["counts"]}
    for r, res in enumerate(ranks):
        for s, st in enumerate(res["steps"]):
            log(f"[ddp] rank {r} step {s}: {st['ms']:.1f} ms, all-reduce "
                f"{st['allreduce_ms']:.1f} ms for {st['allreduce_bytes']} "
                f"bytes in {st['allreduce_calls']} calls (gloo, CUDA "
                f"tensors); losses " + " ".join(
                    f"{k} {v:.5f}" for k, v in st["losses"].items()
                    if k in ("d_img_loss", "d_seg_loss", "g_loss")))
        log(f"[ddp] rank {r}: peak device memory {res['peak_gib']:.2f} GiB, "
            f"launches {res['counts']}, plain-version calls {res['plain']}, "
            f"replicas {res['replicas']}")
    log(f"[ddp] 2 gloo ranks on one {card()} (24 per rank, 48 global, "
        f"split 4, topk {DDP_TOPK}, ray kernels on) against one process on "
        f"the 48-image batch: max loss diff per step (absolute at the "
        f"first, relative after) {[f'{x:.3g} ({k})' for x, k in loss_gaps]}"
        f" (tol {DDP_LOSS_TOL}, {DDP_LOSS2_TOL}), max |G param diff| "
        f"{param_err:.3g} (tol {DDP_PARAM_TOL}); the witness, one process "
        f"full-batch on the same draws: "
        f"{[f'{x:.3g} ({k})' for x, k in witness_gaps]}, "
        f"{witness_param:.3g}, its losses "
        f"{[{k: round(v, 5) for k, v in m.items()} for m in runs['witness'][0]]}"
        f"; one process's losses "
        f"{[{k: round(v, 5) for k, v in m.items()} for m in one]}; "
        f"{wall:.1f} s for both ranks with their start")
    if any(r["replicas"] != "bit-identical" for r in ranks):
        raise AssertionError(f"[ddp] replicas: {[r['replicas'] for r in ranks]}")
    if not (loss_err[0] <= DDP_LOSS_TOL and max(loss_err) <= DDP_LOSS2_TOL
            and param_err <= DDP_PARAM_TOL):
        raise AssertionError("[ddp] the ranks disagree with one process")
    for r, res in enumerate(ranks):
        if res["counts"] != want or res["plain"]:
            raise AssertionError(f"[ddp] rank {r} launches {res['counts']}, "
                                 f"plain {res['plain']}; expected {want}")
    return {"launches": {k: sum(r["counts"][k] for r in ranks)
                         for k in want},
            # the last step's: the first builds each process's state
            "ms_per_step": [r["steps"][-1]["ms"] for r in ranks],
            "loss_err": loss_err, "param_err": param_err,
            "witness_err": witness_err, "witness_param": witness_param}


def _nccl_cli(dev, tmp) -> dict:
    """(ii): the trainer's CLI at world size 1 over NCCL (--coordinator) in
    this process, 3 steps with a checkpoint (the supervised run of (iii)
    resumes from it); an NCCL all-reduce at world size 1 beside it."""
    from fenerf_tpu_torch.apps import train as train_cli
    from fenerf_tpu_torch.data import synthetic
    from fenerf_tpu_torch.train import sharding

    group = sharding.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    backend = torch.distributed.get_backend()
    x = torch.arange(4.0, device=dev)
    torch.distributed.all_reduce(x)
    sharding.shutdown()
    if backend != "nccl" or group.device.type != "cuda" or \
            x.tolist() != [0.0, 1.0, 2.0, 3.0]:
        raise AssertionError(f"[ddp cli] {backend} at world size 1 on "
                             f"{group.device}: {x.tolist()}")
    fixtures = [str(synthetic.FIXTURES / n)
                for n in sorted(synthetic.fixture_digests())]
    root = synthetic.write_celebamask_tree(os.path.join(tmp, "ddp_tree"),
                                           fixtures, count=DDP_CLI_PAIRS)
    out = os.path.join(tmp, "ddp_cli")
    common = TRAIN_CLI + ["--data_root", root, "--sample_interval", "0",
                          "--eval_freq", "0"]
    tee = _Tee(sys.stdout)
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        state = train_cli.main(
            common + ["--output_dir", out, "--coordinator",
                      f"127.0.0.1:{_free_port()}", "--num_processes", "1",
                      "--process_id", "0", "--total_steps", "3",
                      "--model_save_interval", "3"])
    counts, plain = read_counts()
    text = "".join(tee.lines)
    log(f"[ddp cli] 3 steps over NCCL at world size 1: "
        f"{time.perf_counter() - t0:.1f} s, launches {counts}, "
        f"plain-version calls {plain}")
    if "(nccl)" not in text or plain or counts["film_mlp"] != 72 \
            or int(state.step) != 3:
        raise AssertionError(f"[ddp cli] {text[-2000:]}")
    return {"launches": counts, "root": root, "out": out}


def _supervised(cli: dict, tmp) -> None:
    """(iii): apps/supervise.py around the same CLI (its own processes):
    the run resumes from (ii)'s checkpoint, this phase kills the trainer's
    process group once metrics.jsonl shows step DDP_KILL_AT, and the
    relaunch resumes from the run's own checkpoint and finishes."""
    import shutil
    import subprocess

    # the trainer processes share the card with this one, whose allocator
    # keeps the earlier phases' blocks (the witness's full-batch pass among
    # them) cached otherwise
    torch.cuda.empty_cache()
    run = os.path.join(tmp, "ddp_supervised")
    os.makedirs(run)
    shutil.copy(os.path.join(cli["out"], "train_state.npz"), run)
    log_base = os.path.join(run, "supervise.log")
    metrics = os.path.join(run, "metrics.jsonl")
    trainer = [sys.executable, "-m", "fenerf_tpu_torch.apps.train",
               *TRAIN_CLI, "--data_root", cli["root"], "--output_dir", run,
               "--load_dir", run, "--total_steps",
               str(DDP_SUPERVISED_STEPS), "--model_save_interval", "1",
               "--sample_interval", "0", "--eval_freq", "0",
               "--coordinator", f"127.0.0.1:{_free_port()}",
               "--num_processes", "1", "--process_id", "0"]
    t0 = time.perf_counter()
    sup = subprocess.Popen(
        [sys.executable, "-m", "fenerf_tpu_torch.apps.supervise", "--log",
         log_base, "--watch", metrics, "--stall_s", "300",
         "--startup_grace_s", "300", "--poll_s", "0.5", "--max_restarts",
         "2", "--", *trainer], cwd=str(Path(__file__).resolve().parent),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    events = log_base + ".events.jsonl"
    killed = None
    try:
        deadline = time.time() + 300
        while killed is None and time.time() < deadline:
            steps = []
            if os.path.exists(metrics):
                with open(metrics) as f:
                    steps = [json.loads(x)["step"] for x in f if x.strip()]
            if DDP_KILL_AT in steps:
                with open(events) as f:
                    pid = [json.loads(x) for x in f][0]["pid"]
                os.killpg(pid, signal.SIGKILL)
                killed = time.perf_counter() - t0
            elif sup.poll() is not None:
                break
            time.sleep(0.2)
        out, _ = sup.communicate(timeout=300)
    finally:
        if sup.poll() is None:
            sup.kill()
            sup.wait()
    with open(events) as f:
        names = [json.loads(x)["event"] for x in f]
    with open(log_base + ".1") as f:
        second = f.read()
    with open(metrics) as f:
        steps = [json.loads(x)["step"] for x in f]
    with np.load(os.path.join(run, "train_state.npz")) as st:
        n = json.loads(str(st["__manifest__"]))["n"]
        final = int(st[f"leaf_{n - 1}"])
    log(f"[ddp supervise] killed the trainer's process group at "
        f"{killed if killed is None else round(killed, 1)} s (metrics at "
        f"step {DDP_KILL_AT}); events {names}; the relaunch: "
        f"{[ln for ln in second.splitlines() if 'resumed' in ln]}; steps "
        f"logged {steps}; final checkpoint at step {final}; "
        f"{time.perf_counter() - t0:.1f} s")
    if (killed is None or sup.returncode != 0
            or names != ["launched", "exit", "relaunching", "launched",
                         "done"]
            or "resumed from" not in second or final != DDP_SUPERVISED_STEPS
            or steps[0] != 3 or steps[-1] != DDP_SUPERVISED_STEPS - 1):
        tails = "".join(
            f"\n--- {log_base}.{i}:\n" + Path(f"{log_base}.{i}").read_text()
            [-2000:] for i in range(3) if os.path.exists(f"{log_base}.{i}"))
        raise AssertionError(f"[ddp supervise] failed:\n{out[-3000:]}"
                             f"{tails}")


def phase_ddp(dev) -> dict:
    """Data-parallel training on the one card: (i) two gloo ranks on
    cuda:0 against one process; (ii) the CLI over NCCL at world size 1;
    (iii) the supervisor around it. NCCL refuses two ranks on one device,
    so (i) shows the step's collectives over gloo and (ii) NCCL at world
    size 1 only; no speed across GPUs is shown here."""
    with tempfile.TemporaryDirectory() as tmp:
        ranks = _ddp_two_ranks(dev, tmp)
        cli = _nccl_cli(dev, tmp)
        _supervised(cli, tmp)
    return {"launches": ranks["launches"], "launches_cli": cli["launches"],
            "ms_per_step": ranks["ms_per_step"]}


# ---------------------------------------------------------------------------
# 12. sharded: the ray-parallel renders and the sharded lattices
# ---------------------------------------------------------------------------

SHARDS = 4
SHARD_SIZE = 256                   # render_multiview's default
SHARD_CAMERA = (math.pi * 0.5, math.pi * 0.5 + 0.3, 12.0)
SHARD_SHAPES = ["--voxel_resolution", "128", "--chunk", "65536"]
SHARD_VIDEO = ["--num_frames", "3"]


def _shard_renders(ckpt, grid_ckpt, dev, sharded: bool) -> dict:
    """render_multiview's 256^2 view of each family on both ray routes,
    whole or in SHARDS strips on `dev`."""
    from fenerf_tpu_torch.apps.common import best_backend, load_generator
    from fenerf_tpu_torch.models import generator as gen
    from fenerf_tpu_torch.nn import fields
    from fenerf_tpu_torch.ops import film_mlp
    from fenerf_tpu_torch.utils.precision import exact_matmuls

    out = {}
    for family, path, fill in (("film", ckpt, "seg_padding_background"),
                               ("grid", grid_ckpt, "eval_white_back")):
        _, params, _, fcfg, _ = load_generator(path, device=dev)
        rcfg = gen.RenderConfig(
            img_size=SHARD_SIZE, num_steps=48, fill_mode=fill,
            ray_chunk=4096, compute_dtype="bfloat16",
            backend=best_backend(fcfg, dev))
        g = torch.Generator(device=dev).manual_seed(3)
        zg = torch.randn((1, fcfg.z_geo_dim), generator=g, device=dev)
        draw = lambda: torch.Generator(device=dev).manual_seed(0)
        with torch.no_grad():
            if family == "film":
                za = torch.randn((1, fcfg.z_app_dim), generator=g, device=dev)
                params = fields.with_grid_table(params, fcfg, torch.bfloat16)
                if rcfg.backend == "kernel":
                    params = film_mlp.with_pack(params, fcfg)
                fg, fa = fields.field_film(params, fcfg, zg, za)
            for ray in ("never", "auto"):
                with ray_kernels(ray):
                    if not sharded and family == "film":
                        pix = gen.render(params, fcfg, rcfg, fg, fa, 1,
                                         camera=SHARD_CAMERA,
                                         generator=draw())["pixels"]
                    elif not sharded:
                        pix = gen.render_grid_from_z(
                            params, fcfg, rcfg, zg, camera=SHARD_CAMERA,
                            generator=draw())["pixels"]
                    elif family == "film":
                        pix = gen.render_image_sharded(
                            params, fcfg, rcfg, fg, fa, [dev] * SHARDS,
                            SHARD_CAMERA, generator=draw())
                    else:
                        pix = gen.render_grid_sharded(
                            params, fcfg, rcfg, zg, [dev] * SHARDS,
                            SHARD_CAMERA, generator=draw())
                out[(family, ray)] = pix
            # the lattice at 256^3 (extract_shapes' default), whole or in
            # slabs of whole chunks
            pts = gen.voxel_points(SHAPES_RES, SHAPES_CUBE, device=dev)
            with exact_matmuls():
                if family == "film":
                    one = lambda f: tuple(t[:1] for t in f)
                    out[(family, "volume")] = (
                        gen.eval_volume_sharded(params, fcfg, one(fg),
                                                one(fa), pts,
                                                [dev] * SHARDS)
                        if sharded else gen.eval_volume(
                            params, fcfg, one(fg), one(fa), pts))
                else:
                    out[(family, "volume")] = (
                        gen.eval_volume_grid_sharded(params, fcfg, zg, pts,
                                                     [dev] * SHARDS)
                        if sharded else gen.eval_volume_grid(
                            params, fcfg, zg, pts))
    torch.cuda.synchronize()
    return out


def _shard_clis(ckpt, grid_ckpt, tmp, sharded: bool) -> dict:
    """render_multiview, render_video and extract_shapes through their
    mains, with --shard_rays over SHARDS strips of this card
    (apps/common.py::visible_devices widened) or without."""
    from fenerf_tpu_torch.apps import common, extract_shapes
    from fenerf_tpu_torch.apps import render_multiview, render_video

    tag = "sharded" if sharded else "whole"
    flag = ["--shard_rays"] if sharded else []
    visible = common.visible_devices
    if sharded:
        common.visible_devices = lambda d: [torch.device(d)] * SHARDS
    out = {}
    try:
        with ray_kernels("auto"):
            for family, path in (("film", ckpt), ("grid", grid_ckpt)):
                d = os.path.join(tmp, f"shard_{family}_{tag}")
                if family == "film":
                    # the grid family's 256^2 sheet takes ~8.5 s a run;
                    # its strips are held above at that size
                    sheets = render_multiview.main(
                        ["--ckpt", path, "--seeds", "7", "--output_dir", d,
                         "--device", "cuda"] + flag)
                    out[(family, "multiview")] = sheets[0][1]
                (video,) = render_video.main(
                    ["--ckpt", path, "--output_dir", d, "--device", "cuda"]
                    + SHARD_VIDEO + flag)
                out[(family, "video")] = video.frames
                extract_shapes.main(["--ckpt", path, "--output_dir", d,
                                     "--device", "cuda"] + SHARD_SHAPES
                                    + flag)
                with open(os.path.join(d, "shape_seed0.mrc"), "rb") as f:
                    out[(family, "mrc")] = f.read()
    finally:
        common.visible_devices = visible
    return out


def phase_sharded(ckpt, grid_ckpt, tmp, dev) -> dict:
    """The ray-parallel renders of both families at render_multiview's
    256^2 in SHARDS strips of this card against the whole render, bit for
    bit on both ray routes; both lattices at 256^3 in SHARDS slabs against
    the whole, bit for bit; the three CLIs with --shard_rays (SHARDS strips
    of this card) against their plain runs. The card's machine has one GPU,
    where the CLIs' --shard_rays takes one strip: the strips here repeat
    cuda:0. Counts from zero around the sharded paths alone."""
    t0 = time.perf_counter()
    whole = _shard_renders(ckpt, grid_ckpt, dev, sharded=False)
    whole_cli = _shard_clis(ckpt, grid_ckpt, tmp, sharded=False)
    t1 = time.perf_counter()
    # --- the main path: counts from zero ---
    zero_counts()
    strips = _shard_renders(ckpt, grid_ckpt, dev, sharded=True)
    strips_cli = _shard_clis(ckpt, grid_ckpt, tmp, sharded=True)
    counts, plain = read_counts()
    t2 = time.perf_counter()
    bad = []
    for key, ref in list(whole.items()) + list(whole_cli.items()):
        got = strips[key] if key in strips else strips_cli[key]
        same = (got == ref if isinstance(ref, bytes)
                else np.array_equal(np.asarray(got), np.asarray(ref))
                if isinstance(ref, np.ndarray) else torch.equal(got, ref))
        if not same:
            bad.append(key)
    log(f"[sharded] {SHARDS} strips / slabs of one {card()}: "
        f"{len(whole) + len(whole_cli)} outputs compared bit for bit "
        f"(renders of both families on both ray routes, both 256^3 "
        f"lattices, the multiview sheets, videos and .mrc of the CLIs), "
        f"{len(bad)} differ {bad}; launches on the sharded paths {counts}, "
        f"plain-version calls {plain}; whole {t1 - t0:.1f} s, sharded "
        f"{t2 - t1:.1f} s")
    need = ("film_mlp", "ray_resample", "ray_finalize")
    if bad or plain or not all(counts[k] for k in need):
        raise AssertionError("[sharded] the strips differ from the whole, "
                             "or a kernel of the path was not launched")
    return {"launches": counts}



# 13: released checkpoints reach the port through the converter
CONVERT_SEED = "7"        # render_multiview's seed for the sheets compared
CONVERT_GRID_SIZE = 128   # the grid family's sheet (its frame size)
CRITIC_BATCH = 4
CRITIC_SIZE = 256
CRITIC_CALLS = 5          # state-threaded calls held to the CPU's
CRITIC_TOL = 1e-4         # of each feature map's largest magnitude, f32
CRITIC_U_TOL = 1e-5
ALIGN_SIZE = 1024         # the synthetic photo; landmarks put qsize > 1024,
ALIGN_EYES = (350.0, 350.0, 260.0, 200.0)   # so shrink 2, crop and pad run


def _standins():
    """tests/torch_reference_standins.py (torch and numpy only): the
    stand-in reference tree and its pickle writer."""
    path = Path(__file__).resolve().parent / "tests" / \
        "torch_reference_standins.py"
    spec = importlib.util.spec_from_file_location("torch_reference_standins",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _convert_clis(jobs: dict, root: str) -> float:
    """python -m fenerf_tpu_torch.apps.convert_checkpoint --model auto for
    each {name: (generator .pth, out .npz)}, in subprocesses started
    together; -> seconds until the last ended."""
    import subprocess

    here = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(here)}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "fenerf_tpu_torch.apps.convert_checkpoint",
         "--generator", gen, "--model", "auto", "--out", out,
         "--reference", root], cwd=here, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, (gen, out) in
        jobs.items()}
    bad = {}
    for name, proc in procs.items():
        text = proc.communicate(timeout=600)[0]
        if proc.returncode:
            bad[name] = text[-3000:]
        else:
            log(f"[convert] {text.strip()}")
    if bad:
        raise AssertionError(f"[convert] the converter failed: {bad}")
    return time.perf_counter() - t0


def _leaves_equal(npz: str, trees: dict) -> int:
    """Every leaf of the converted .npz is bit-equal to the tree it was
    written from ({name: tree}); -> leaves compared."""
    from fenerf_tpu_torch.compat.jax_bridge import to_numpy_tree, tree_leaves

    n = 0
    with np.load(npz) as data:
        for name, tree in trees.items():
            want = tree_leaves(to_numpy_tree(tree))
            if len(want) != sum(k.startswith(f"{name}_") for k in
                                data.files):
                raise AssertionError(f"{npz}: {name} leaf count")
            for i, w in enumerate(want):
                got = data[f"{name}_{i}"]
                if not (got.dtype == w.dtype and np.array_equal(got, w)):
                    raise AssertionError(f"{npz}: {name}_{i} differs")
                n += 1
    return n


def _sheets_equal(a: str, b: str) -> list[str]:
    """The PNGs of two render_multiview directories, byte for byte."""
    names = sorted(os.listdir(a))
    if not names or names != sorted(os.listdir(b)):
        raise AssertionError(f"sheets {names} vs {sorted(os.listdir(b))}")
    for n in names:
        if Path(a, n).read_bytes() != Path(b, n).read_bytes():
            raise AssertionError(f"[convert] {n}: the converted checkpoint's "
                                 "sheet differs from the direct one's")
    return names


def _convert_checkpoints(ckpt, grid_ckpt, tmp, dev) -> dict:
    """The film, grid and HD checkpoints as the reference saves them
    (whole-module pickles of the stand-in tree beside ema.pth / ema2.pth),
    converted by the CLI, held leaf for leaf to the params they were
    written from, then rendered by render_multiview (ray kernels on) bit
    for bit like the directly written checkpoints."""
    import dataclasses

    from fenerf_tpu_torch.apps import render_multiview

    st = _standins()
    root = st.write_tree(os.path.join(tmp, "reference"))
    fcfg, film, _ = _flagship_params(dev, seed=1, sigma_bias=SIGMA_BIAS)
    gcfg, grid = _grid_params(dev)
    hcfg, hd, heads = _hd_params(dev)
    hd_ckpt = write_hd_checkpoint(dev, os.path.join(tmp, "convert_direct"))
    cases = {   # name: (model, params, cfg, wrapper class, heads, the
                #        directly written .npz, render_multiview's flags)
        "film": (FLAGSHIP, film, fcfg, "DoubleImplicitGenerator3d", None,
                 ckpt, []),
        "grid": (GRID, grid, gcfg, "ImplicitGenerator3d", None, grid_ckpt,
                 ["--image_size", str(CONVERT_GRID_SIZE)]),
        "hd": (HD, hd, hcfg, "StyleGenerator3d", heads, hd_ckpt, ["--hd"]),
    }
    t0 = time.perf_counter()
    jobs = {}
    for name, (model, params, cfg, wrapper, hs, _, _) in cases.items():
        sd = (st.grid_state_dict(params) if name == "grid"
              else st.field_state_dict(params, cfg))
        nr = {k: (st.neural_renderer_state_dict(p), dataclasses.asdict(c))
              for k, (p, c) in (hs or {}).items()}
        gen = st.write_generator(root, os.path.join(tmp, f"ref_{name}"),
                                 model, sd, st.field_attrs(cfg), ema=sd,
                                 ema2=sd, heads=nr, wrapper=wrapper)
        jobs[name] = (gen, os.path.join(tmp, f"converted_{name}.npz"))
    t_write = time.perf_counter() - t0
    t_cli = _convert_clis(jobs, root)
    leaves = {}
    for name, (_, params, _, _, hs, _, _) in cases.items():
        trees = {"params": params, "ema": params, "ema2": params}
        trees.update({k: p for k, (p, _) in (hs or {}).items()})
        leaves[name] = _leaves_equal(jobs[name][1], trees)
    launches, ms = {}, {}
    with ray_kernels("auto"):
        for name, (*_, direct, argv) in cases.items():
            out = {}
            for which, path in (("converted", jobs[name][1]),
                                ("direct", direct)):
                out[which] = os.path.join(tmp, f"sheet_{name}_{which}")
                zero_counts()
                t1 = time.perf_counter()
                render_multiview.main(["--ckpt", path, "--seeds",
                                       CONVERT_SEED, "--output_dir",
                                       out[which]] + argv)
                if which == "converted":
                    ms[name] = (time.perf_counter() - t1) * 1e3
                    counts, plain = read_counts()
                    if plain:
                        raise AssertionError(f"[convert] {name}: {plain} "
                                             "plain-version calls")
                    launches[name] = {k: v for k, v in counts.items() if v}
            names = _sheets_equal(out["converted"], out["direct"])
            log(f"[convert] {name}: {leaves[name]} leaves bit-equal to the "
                f"written params; {' '.join(['render_multiview'] + argv)}: "
                f"sheets {names} of the converted .npz equal to the direct "
                f"one's, byte for byte ({ms[name]:.0f} ms for the converted "
                f"one, CLI start included); launches {launches[name]}")
    need = {"film": ("film_mlp", "ray_resample", "ray_finalize"),
            "grid": ("ray_resample", "ray_finalize"),
            "hd": ("film_mlp", "ray_resample", "ray_finalize")}
    for name, kernels in need.items():
        if not all(launches[name].get(k, 0) for k in kernels):
            raise AssertionError(f"[convert] {name}: a kernel of the path "
                                 f"was not launched: {launches[name]}")
    total = {}
    for counts in launches.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    log(f"[convert] pickles written in {t_write:.1f} s (three generators, "
        f"each with ema.pth and ema2.pth), the three CLIs in {t_cli:.1f} s "
        f"(together)")
    return {"launches": total, "cli_s": t_cli}


def _critic_check(dev) -> dict:
    """The SPADE multiscale patch critic at the JAX defaults (input_nc 22,
    ndf 64, n_layers 3, num_d 3) on a batch of 4 at 256^2: every feature
    map on the card against the CPU's (f32, CRITIC_TOL of its largest
    magnitude), CRITIC_CALLS state-threaded calls' u against the CPU's,
    ms per call on both."""
    from fenerf_tpu_torch.compat.jax_bridge import tree_leaves, tree_map
    from fenerf_tpu_torch.nn import discriminators as d

    cpu = d.init_multiscale_discriminator(torch.Generator().manual_seed(0))
    card = tree_map(lambda t: t.to(dev) if isinstance(t, torch.Tensor)
                    else t, cpu)
    x = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (CRITIC_BATCH, 22, CRITIC_SIZE, CRITIC_SIZE)).astype(np.float32))
    xd = x.to(dev)
    with torch.no_grad():
        got = tree_leaves(d.apply_multiscale_discriminator(card, xd))
        t0 = time.perf_counter()
        ref = tree_leaves(d.apply_multiscale_discriminator(cpu, x))
        cpu_ms = (time.perf_counter() - t0) * 1e3
        err = max(float((g.cpu() - r).abs().max() / r.abs().max())
                  for g, r in zip(got, ref))
        pc, pd = cpu, card
        for _ in range(CRITIC_CALLS):
            _, pc = d.apply_multiscale_discriminator(pc, x, return_state=True)
            _, pd = d.apply_multiscale_discriminator(pd, xd,
                                                     return_state=True)
        u_err = max(float((lc["u"] - ld["u"].cpu()).abs().max())
                    for sc, sd in zip(pc["scales"], pd["scales"])
                    for lc, ld in zip(sc["layers"], sd["layers"])
                    if lc["sn"])
        ms = time_ms(lambda: d.apply_multiscale_discriminator(card, xd),
                     iters=10)
    log(f"[convert] SPADE multiscale critic (22 -> 64 ch, 3 layers, 3 "
        f"scales) on {CRITIC_BATCH} x {CRITIC_SIZE}^2: {len(got)} feature "
        f"maps card vs CPU max|diff|/max {err:.2e} (tol {CRITIC_TOL}); u "
        f"after {CRITIC_CALLS} state-threaded calls max|diff| {u_err:.2e} "
        f"(tol {CRITIC_U_TOL}); {ms:.3f} ms per call on the card (CUDA "
        f"events, 10 calls), {cpu_ms:.0f} ms on the CPU")
    if not (err <= CRITIC_TOL and u_err <= CRITIC_U_TOL):
        raise AssertionError(f"[convert] the critic: {err}, u {u_err}")
    return {"ms": ms, "err": err, "u_err": u_err}


def _align_check(tmp, dev) -> dict:
    """align_face on a seeded synthetic 1024^2 photo whose landmarks take
    the shrink, crop and pad branches (the port's PIL-exact LANCZOS and
    QUAD, no PIL), then prepare_segmaps' BiSeNet on the card on the aligned
    face with stand-in weights."""
    from fenerf_tpu_torch.apps import prepare_segmaps
    from fenerf_tpu_torch.nn import bisenet
    from fenerf_tpu_torch.utils import align
    from fenerf_tpu_torch.utils.image import read_png, resize, save_png

    rng = np.random.RandomState(0)
    img = resize(rng.randint(0, 256, (64, 64, 3)).astype(np.uint8),
                 (ALIGN_SIZE, ALIGN_SIZE), "bilinear")
    cx, cy, eye, mouth = ALIGN_EYES
    lm = rng.uniform(-3, 3, (68, 2)) + [cx, cy]
    lm[36:42] = [cx - eye / 2, cy] + rng.uniform(-2, 2, (6, 2))
    lm[42:48] = [cx + eye / 2, cy] + rng.uniform(-2, 2, (6, 2))
    lm[48] = [cx - eye / 3, cy + mouth]
    lm[54] = [cx + eye / 3, cy + mouth]
    _, qsize = align.alignment_quad(lm)
    shrink = int(np.floor(qsize / 256 * 0.5))
    t0 = time.perf_counter()
    face = align.align_face(img, lm)
    host_ms = (time.perf_counter() - t0) * 1e3
    if not (face.shape == (256, 256, 3) and face.dtype == np.uint8
            and face.std() > 1.0):
        raise AssertionError(f"[convert] align_face gave {face.shape} "
                             f"{face.dtype}, std {face.std():.2f}")
    pil = "PIL" in sys.modules
    photos = os.path.join(tmp, "aligned")
    os.makedirs(photos)
    save_png(os.path.join(photos, "face.png"), face)
    weights = os.path.join(tmp, "segNet-20Class-align.pth")
    torch.save(bisenet.stand_in_state_dict(0), weights)
    masks = os.path.join(tmp, "aligned_masks")
    res = prepare_segmaps.main(["--images", os.path.join(photos, "*.png"),
                                "--weights", weights, "--size", "256",
                                "--output_dir", masks,
                                "--device", str(dev)])
    parsed = read_png(os.path.join(masks, "face.png"))
    log(f"[convert] align_face on a {ALIGN_SIZE}^2 photo (qsize "
        f"{qsize:.0f}, shrink {shrink}): {host_ms:.1f} ms on the host, PIL "
        f"imported: {pil}; prepare_segmaps' BiSeNet on {dev} parsed it to "
        f"{parsed.shape} labels {np.unique(parsed).tolist()[:8]}... in "
        f"{res['seconds']:.2f} s")
    if shrink < 2 or pil or parsed.shape != (256, 256):
        raise AssertionError("[convert] alignment: shrink, PIL or the map")
    return {"host_ms": host_ms}


def phase_convert(ckpt, grid_ckpt, tmp, dev) -> dict:
    """13. Released checkpoints in the port: the converter on reference
    pickles of the film, grid and HD checkpoints, rendered through the
    field and ray kernels; the SPADE patch critics on the card; face
    alignment without PIL before the parser."""
    out = _convert_checkpoints(ckpt, grid_ckpt, tmp, dev)
    out["critic"] = _critic_check(dev)
    out["align"] = _align_check(tmp, dev)
    return out


def _children(pid: int) -> list[int]:
    """The processes whose parent is `pid`, zombies included (/proc)."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            stat = Path("/proc", entry, "stat").read_text()
        except OSError:   # it ended while we looked
            continue
        if int(stat.rpartition(")")[2].split()[1]) == pid:
            out.append(int(entry))
    return out


def stop_helper_processes() -> None:
    """Stops every process this script started, waiting for each: the fork
    server the training loader's workers come from and multiprocessing's
    resource tracker (left alone, both outlive the script while they shut
    down), then any other child still there."""
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()
    for pid in _children(os.getpid()):
        log(f"[exit] stopping leftover child process {pid}")
        with contextlib.suppress(ProcessLookupError, ChildProcessError):
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)


def run_phases(dev: torch.device) -> dict:
    """Every phase in turn; -> the kernels line."""
    from fenerf_tpu_torch.train.curriculum import CURRICULA

    t_all = time.perf_counter()
    spent = {}   # seconds per phase, host clock

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
        return out

    timed("card and build", phase_card)
    kern = timed("kernel", phase_kernel, dev)
    resample, finalize = timed("ray", phase_ray, dev)
    fold = timed("fold", phase_fold, dev)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = write_checkpoint(dev, tmp)
        serve = {ray: timed("serve", phase_serve, ckpt, ray)
                 for ray in ("never", "auto")}
        log(f"[serve] batch-1 ms/request, ray kernels off / on: "
            f"{serve['never']['ms_per_request']:.1f} / "
            f"{serve['auto']['ms_per_request']:.1f}")
        multiview = timed("multiview", phase_multiview, ckpt, tmp, dev)
        timed("shapes", phase_shapes, ckpt, tmp)
        inv_ckpt = write_checkpoint(dev, tmp, INVERT_SIGMA_BIAS,
                                    INVERT_HEAD_GAIN, "generator_invert.npz")
        inverted = timed("invert", phase_invert, inv_ckpt, tmp, dev)
        # config 4: video of both families, the grid family's other paths
        grid_ckpt = write_grid_checkpoint(dev, tmp)
        grid_video = timed("grid video", phase_grid_video, grid_ckpt, tmp,
                           dev)
        film_video = timed("film video", phase_film_video, ckpt, tmp, dev)
        grid_apps = timed("grid apps", phase_grid_apps, grid_ckpt, tmp)
        log(f"[video] ms per frame: grid, ray kernels off / on "
            f"{grid_video['ms_per_frame_never']:.1f} / "
            f"{grid_video['ms_per_frame_auto']:.1f}; film, kernels "
            f"{film_video['ms_per_frame']:.1f} (torch routes "
            f"{film_video['ms_per_frame_torch']:.1f}); grid sheet "
            f"{grid_apps['ms_per_sheet']:.1f} ms, grid volume "
            f"{grid_apps['volume_s']:.2f} s")
        # 5g: the editing workflow's mask half
        edit = timed("edit loop", phase_edit_loop, ckpt, inv_ckpt, tmp, dev)
        # 12: the ray-parallel renders and the sharded lattices
        sharded = timed("sharded", phase_sharded, ckpt, grid_ckpt, tmp, dev)
        # 13: reference checkpoints through the converter, the patch
        # critics, face alignment
        convert = timed("convert", phase_convert, ckpt, grid_ckpt, tmp, dev)
    timed("render", phase_render, dev)
    bwd = timed("backward", phase_backward, dev)
    # the backward at invert's shape (phase 5c) beside phase 7's shapes
    shapes = bwd["shapes"] + [inverted["bwd"]]
    bwd = {**bwd, "max_abs_err": max(x["max_abs_err"] for x in shapes),
           "max_rel_err": max(x["max_rel_err"] for x in shapes),
           "min_cos": min(x["min_cos"] for x in shapes), "shapes": shapes}
    train_off, trained = timed("train", phase_train, dev, ray_on=False)
    train_on, _ = timed("train", phase_train, dev, ray_on=True)
    log(f"[train] ms/step, ray kernels off / on: "
        f"{train_off['ms_per_step']:.1f} / {train_on['ms_per_step']:.1f}")
    train_cli = timed("train cli", phase_train_cli, dev)
    grid_train = timed("grid train", phase_grid_train, dev)
    log(f"[grid train] {GRID_CURRICULUM} stage 0: "
        f"{grid_train['ms_per_step']:.1f} ms/step, "
        f"{grid_train['imgs_per_s']:.2f} images/s, peak "
        f"{grid_train['peak_gib']:.2f} GiB")
    # 11: data-parallel training, the multi-process CLI, the supervisor
    ddp = timed("ddp", phase_ddp, dev)
    timed("grad", phase_grad, dev, CURRICULA[TEXTURE].at_step(0),
          (trained, TRAIN_STEPS))
    probe_launches, probe_results = timed("probe scripts",
                                          phase_probe_scripts)
    probes = timed("probes", phase_probes, dev, probe_results)
    log(f"[done] all phases in {time.perf_counter() - t_all:.1f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in spent.items()))

    def launches(name):
        """Launches on the main paths: serving (both ray routes), training
        (ray kernels off and on), multiview sheets (both ray routes), the
        inversion (with its warm start and its video), video (the grid
        family on both ray routes, the film family on the kernels), the
        grid family's multiview sheet, the trainer's CLI (stage 0, its
        resume and the 64^2 stage) and the grid family's training (none:
        the path has no kernel, as the JAX trainer's has none), the
        edit loop (its face and score renders, its inversion, its HD
        sheets), the data-parallel step's two ranks and the CLI over NCCL
        (ddp), the sharded renders and CLIs (sharded) and the renders of
        the converted reference checkpoints (convert)."""
        by_path = {"serve": sum(r["launches"][name] for r in serve.values()),
                   "train": (train_off["launches"][name]
                             + train_on["launches"][name]),
                   "multiview": sum(r[name] for r in
                                    multiview["launches"].values()),
                   "invert": inverted["launches"][name],
                   "video": (sum(r[name] for r in
                                 grid_video["launches"].values())
                             + film_video["launches"][name]),
                   "grid_multiview": grid_apps["launches"][name],
                   "train_cli": sum(r.get(name, 0) for r in
                                    train_cli["launches"].values()),
                   "grid_train": sum(r.get(name, 0) for r in
                                     grid_train["launches"].values()),
                   "edit": edit["launches"][name],
                   "ddp": (ddp["launches"].get(name, 0)
                           + ddp["launches_cli"].get(name, 0)),
                   "sharded": sharded["launches"][name],
                   "convert": convert["launches"].get(name, 0)}
        return {"launches": sum(by_path.values()),
                **{f"launches_{k}": v for k, v in by_path.items()}}

    src = "fenerf_tpu_torch/ops/csrc/"

    def headers(source):
        """The csrc headers a kernel's source builds on (hopper.cuh, ...)."""
        text = (Path(__file__).resolve().parent / src / source).read_text()
        return {"headers": re.findall(r'^#include "(\S+\.cuh)"', text,
                                      re.M)}

    return {"kernels": [
        {"name": "film_mlp", "route": "cuda", "source": src + "film_mlp.cu",
         "replaces": "fenerf_tpu/ops/film_mlp.py:128",
         **headers("film_mlp.cu"), **launches("film_mlp"), **kern},
        {"name": "film_mlp_bwd", "route": "cuda",
         "source": src + "film_mlp_bwd.cu",
         "replaces": "fenerf_tpu/ops/film_mlp_grad.py:85",
         **headers("film_mlp_bwd.cu"), **launches("film_mlp_bwd"), **bwd},
        {"name": "ray_resample", "route": "cuda",
         "source": src + "ray_finalize.cu",
         "replaces": "fenerf_tpu/ops/ray_finalize.py:97",
         **headers("ray_finalize.cu"), **launches("ray_resample"), **resample},
        {"name": "ray_finalize", "route": "cuda",
         "source": src + "ray_finalize.cu",
         "replaces": "fenerf_tpu/ops/ray_finalize.py:221",
         **headers("ray_finalize.cu"), **launches("ray_finalize"), **finalize},
        {"name": "fold_zexp", "route": "cuda", "source": src + "zexp_fold.cu",
         "replaces": "fenerf_tpu/ops/zexp_fold.py:46",
         **headers("zexp_fold.cu"), **launches("fold_zexp"), **fold}] + [
        {"name": name, "route": "cuda", "source": src + source,
         "replaces": replaces, **headers(source),
         "launches": probe_launches[name], **probes[name]}
        for name, source, replaces in (
            ("run_chain", "mxu_chain.cu", "scripts/profile_mxu_chain.py:50"),
            ("run_wide", "mxu_wide.cu", "scripts/profile_mxu_chain.py:86"),
            ("run_epi", "mxu_chain.cu",
             "scripts/profile_epilogue_overlap.py:53"),
            ("ring_dma_gather", "dma_gather.cu",
             "scripts/profile_dma_gather.py:55"))]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the training loader's DataLoader workers fork from multiprocessing's
    # fork server; with the loader's module (and so torch) loaded there
    # once, each worker starts in a fraction of a second, not seconds
    import multiprocessing

    multiprocessing.set_forkserver_preload(
        ["fenerf_tpu_torch.data.celeba_mask"])
    try:
        kernels = run_phases(torch.device("cuda"))
    finally:
        stop_helper_processes()
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
