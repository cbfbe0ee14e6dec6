"""The texture-row gather's rate, alone and under the products, on one
NVIDIA GPU: the port's counterpart of scripts/profile_dma_gather.py.

  python scripts/profile_torch_dma_gather.py [--iters 10]
      [--out chiprun_out/profile_torch_dma_gather.json]

2^18 uniform indices into a 97^3-row bf16 table drawn on the card, through
the hand-written CUDA kernel ops/csrc/dma_gather.cu (one bulk copy in and
one out per row):
  ring_dma_r{R}        the TPU layout's 2 KB rows (97^3, 8, 128), 1.87 GB,
                       at most R row copies in flight per 1024-index CTA
  ring_overlap_r{R}    the same gather with the 11-layer bf16 chain over a
                       (2^18, 256) activation in the same kernel
  ring_overlap_16b_r{R}  the same kernel over a table of 16 B rows: the
                       chain's own time in that kernel, nearly no gather
                       (ring_overlap_r{R} minus it: what the 2 KB gather
                       adds beside the chain)
  ring_dma_512b_r{R}   the flagship table's own 512 B rows (97^3, 256)
Context, not a kernel of the port: torch_index_select and
torch_index_select_512b, the library call that computes the same gather;
torch_contiguous_copy and torch_contiguous_copy_512b, a copy of the first n
rows in order, which moves the same bytes without the scatter (what the
memory system gives this mix of reads and writes at best).

Both tables exceed the 50 MB L2 many times over, so repeated calls on the
same indices still read device memory. Prints each variant's ms (CUDA
events), GB/s, Mrows/s and bound (bytes over the memory rate; for the
overlap also the chain's products), and writes them with the card's name
and power limit to --out. Needs CUDA.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fenerf_tpu_torch.ops import dma_gather, probes  # noqa: E402

RINGS = (16, 32, 64)
OVERLAP_RINGS = (8, 16, 32)
RINGS_512B = (16, 64, 256)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default="chiprun_out/profile_torch_dma_gather.json")
    args = ap.parse_args(argv)
    dev = probes.require_cuda("profile_torch_dma_gather")
    card = probes.card()
    print(card, flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    n = probes.N_IDX
    res = {}

    def run(name, fn, flops, nbytes):
        res[name] = probes.report(name, probes.time_ms(fn, args.iters),
                                  flops, nbytes, rows=n)

    table, idx = probes.table_inputs(gen, probes.ROW_TPU, n, dev)
    nbytes = probes.gather_bytes(n, 2 * table[0].numel())
    for ring in RINGS:
        run(f"ring_dma_r{ring}",
            lambda: dma_gather.ring_dma_gather(table, idx, ring), 0, nbytes)
    run("torch_index_select", lambda: table.index_select(0, idx), 0, nbytes)
    out = torch.empty((n,) + tuple(table.shape[1:]), dtype=table.dtype,
                      device=dev)
    run("torch_contiguous_copy", lambda: out.copy_(table[:n]), 0, nbytes)
    del out
    x, w = probes.chain_inputs(gen, n, probes.H, probes.LAYERS, dev)
    flops, chain_bytes = probes.chain_cost(n, probes.H, probes.LAYERS)
    for ring in OVERLAP_RINGS:
        run(f"ring_overlap_r{ring}",
            lambda: dma_gather.ring_dma_gather(table, idx, ring, ws=w, x=x,
                                               overlap=True),
            flops, nbytes + chain_bytes)
    del table
    small, idx16 = probes.table_inputs(gen, (8,), n, dev)
    for ring in OVERLAP_RINGS:
        run(f"ring_overlap_16b_r{ring}",
            lambda: dma_gather.ring_dma_gather(small, idx16, ring, ws=w, x=x,
                                               overlap=True),
            flops, probes.gather_bytes(n, 16) + chain_bytes)
    del small, x, w
    table, idx = probes.table_inputs(gen, probes.ROW_FLAGSHIP, n, dev)
    nbytes = probes.gather_bytes(n, 2 * table[0].numel())
    for ring in RINGS_512B:
        run(f"ring_dma_512b_r{ring}",
            lambda: dma_gather.ring_dma_gather(table, idx, ring), 0, nbytes)
    run("torch_index_select_512b", lambda: table.index_select(0, idx), 0,
        nbytes)
    out = torch.empty((n,) + tuple(table.shape[1:]), dtype=table.dtype,
                      device=dev)
    run("torch_contiguous_copy_512b", lambda: out.copy_(table[:n]), 0,
        nbytes)
    probes.write_json(args.out, {"card": card,
                                 "iters": args.iters, "variants": res})
    return 0


if __name__ == "__main__":
    sys.exit(main())
