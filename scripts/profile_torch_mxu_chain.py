"""The fused field's product ceiling on one NVIDIA GPU: the port's
counterpart of scripts/profile_mxu_chain.py.

  python scripts/profile_torch_mxu_chain.py [--iters 10]
      [--out chiprun_out/profile_torch_mxu_chain.json]

Variants, through the hand-written CUDA kernels ops/csrc/mxu_chain.cu and
ops/csrc/mxu_wide.cu (both wgmma):
  chain_t64      the 11-layer bf16 chain a <- bf16(a @ W) over (2^20, 256),
                 each consumer warpgroup on its own 64-row tiles
  chain_t128     the same, both consumers on one 128-row tile, every weight
                 stage feeding both (half the L2 weight stream)
  ilv2_t128      chain_t128 with the two consumers one pass apart (the TPU
                 kernel's k-way row interleave, k = 2)
  wide_t64       5 layers at width 512 over (2^19, 512): the same FLOPs
                 per point, wider products; each consumer warpgroup on its
                 own 64-row tiles, A from shared memory
  wide_t128      the same, both consumers on one 128-row tile
Context, not a kernel of the port: torch_matmul_chain / torch_matmul_wide,
the same number of torch.matmul bf16 calls in a row (bf16 reductions in
f32), which round to bf16 between layers only because their outputs are
bf16.

Prints each variant's ms (CUDA events), TFLOP/s and bound (the bf16
tensor-core peak), and writes them with the card's name and power limit to
--out. Needs CUDA.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fenerf_tpu_torch.ops import mxu_chain, probes  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default="chiprun_out/profile_torch_mxu_chain.json")
    args = ap.parse_args(argv)
    dev = probes.require_cuda("profile_torch_mxu_chain")
    card = probes.card()
    print(card, flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {}

    def run(name, fn, n, h, layers):
        flops, nbytes = probes.chain_cost(n, h, layers)
        res[name] = probes.report(name, probes.time_ms(fn, args.iters),
                                  flops, nbytes, rows=n)

    x, w = probes.chain_inputs(gen, probes.N_PTS, probes.H, probes.LAYERS,
                               dev)
    shape = (probes.N_PTS, probes.H, probes.LAYERS)
    for tile, k in mxu_chain.VARIANTS:
        run(probes.chain_variant(tile, k),
            lambda: mxu_chain.run_chain(x, w, tile, interleave=k), *shape)

    def matmuls(a, ws):
        for wi in ws:
            a = a @ wi
        return a

    run("torch_matmul_chain", lambda: matmuls(x, w), *shape)
    del x, w
    x, w = probes.chain_inputs(gen, probes.WIDE_N, probes.WIDE_H,
                               probes.WIDE_LAYERS, dev)
    shape = (probes.WIDE_N, probes.WIDE_H, probes.WIDE_LAYERS)
    for tile in mxu_chain.WIDE_TILES:
        run(probes.wide_variant(tile),
            lambda: mxu_chain.run_wide(x, w, tile), *shape)
    run("torch_matmul_wide", lambda: matmuls(x, w), *shape)
    probes.write_json(args.out, {"card": card,
                                 "iters": args.iters, "variants": res})
    return 0


if __name__ == "__main__":
    sys.exit(main())
