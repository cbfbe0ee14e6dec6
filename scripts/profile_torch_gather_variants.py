"""A/B of the gather kernel's issuing warps and tile on one NVIDIA GPU:
builds ops/csrc/dma_gather.cu with GATHER_WARPS = 1, 2, 4, 8 and 16 (one
elected lane per warp issues the bulk copies of its share of the ring) at
the TPU kernel's tile of 1024 indices, and with 8 warps at tiles of 512 and
256, and times them in turns in one process at the probe script's rings,
with 2 KB and 512 B rows.

  python scripts/profile_torch_gather_variants.py [--iters 20] [--rounds 2]
      [--out chiprun_out/profile_torch_gather_variants.json]

Each round times the variants in order and then in reverse (the mean over
all rounds is a variant's time), after checking each bit-exact against
index_select. Prints ms, share of the bound and index_select's time; writes
them with the card's name and power limit to --out. Needs CUDA and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fenerf_tpu_torch.ops import build, dma_gather, probes  # noqa: E402

# (issuing warps, indices per CTA)
VARIANTS = ((1, 1024), (2, 1024), (4, 1024), (8, 1024), (16, 1024),
            (8, 512), (8, 256))
# the lines of dma_gather.cu a variant rewrites
SOURCE_WARPS = "constexpr int GATHER_WARPS = 8;"
SOURCE_TILE = "constexpr int TILE = 1024;"


def variants() -> dict:
    """{(warps, tile): the loaded library of dma_gather.cu built with them},
    one nvcc each, in parallel, into build/."""
    src = (build.CSRC / "dma_gather.cu").read_text()
    for line in (SOURCE_WARPS, SOURCE_TILE):
        if line not in src:
            raise RuntimeError(f"dma_gather.cu no longer holds {line!r}")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for w, t in VARIANTS:
        cu = build.BUILD_DIR / f"dma_gather_w{w}_t{t}.cu"
        cu.write_text(src.replace(
            SOURCE_WARPS, f"constexpr int GATHER_WARPS = {w};").replace(
            SOURCE_TILE, f"constexpr int TILE = {t};"))
        so = cu.with_suffix(".so")
        jobs[w, t] = (so, subprocess.Popen(
            build.command(cu, so), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        libs[key] = dma_gather.bind(ctypes.CDLL(str(so)))
    return libs


def _profile_script():
    """scripts/profile_torch_dma_gather.py, for its rings."""
    path = Path(__file__).with_name("profile_torch_dma_gather.py")
    spec = importlib.util.spec_from_file_location("_profile_dma", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out",
                    default="chiprun_out/profile_torch_gather_variants.json")
    args = ap.parse_args(argv)
    dev = probes.require_cuda("profile_torch_gather_variants")
    card = probes.card()
    print(card, flush=True)
    libs = variants()
    gen = torch.Generator(device=dev).manual_seed(0)
    script = _profile_script()
    res = {}
    shipped = dma_gather._LIB
    try:
        for row_shape, rings in ((probes.ROW_TPU, script.RINGS),
                                 (probes.ROW_FLAGSHIP, script.RINGS_512B)):
            table, idx = probes.table_inputs(gen, row_shape, probes.N_IDX,
                                             dev)
            row_bytes = 2 * table[0].numel()
            ref = table.index_select(0, idx)
            lib_ms = probes.time_ms(lambda: table.index_select(0, idx),
                                    args.iters)
            bound, _ = probes.bound_ms(
                0, probes.gather_bytes(probes.N_IDX, row_bytes))
            for ring in rings:
                times = {key: [] for key in VARIANTS}
                for key in VARIANTS:
                    dma_gather._LIB = libs[key]
                    if not torch.equal(dma_gather.ring_dma_gather(
                            table, idx, ring), ref):
                        raise AssertionError(f"{key}, ring {ring}, "
                                             f"{row_bytes} B rows: wrong rows")
                for _ in range(args.rounds):
                    for key in VARIANTS + VARIANTS[::-1]:
                        dma_gather._LIB = libs[key]
                        times[key].append(probes.time_ms(
                            lambda: dma_gather.ring_dma_gather(
                                table, idx, ring), args.iters))
                for w, t in VARIANTS:
                    ms = sum(times[w, t]) / len(times[w, t])
                    name = f"{row_bytes}b_r{ring}_w{w}_t{t}"
                    res[name] = {"ms": ms, "times": times[w, t],
                                 "bound_ms": bound,
                                 "share_of_bound": bound / ms,
                                 "index_select_ms": lib_ms}
                    print(f"{name}: {ms:.4f} ms ({bound / ms:.1%} of the "
                          f"{bound:.4f} ms bound; spread "
                          f"{min(times[w, t]):.4f}-{max(times[w, t]):.4f}), "
                          f"index_select {lib_ms:.4f} ms", flush=True)
            del table, idx, ref
    finally:
        dma_gather._LIB = shipped
    probes.write_json(args.out, {"card": card, "iters": args.iters,
                                 "rounds": args.rounds, "variants": res})
    return 0


if __name__ == "__main__":
    sys.exit(main())
