"""Whether the FiLM / sine epilogue hides under the products, on one NVIDIA
GPU: the port's counterpart of scripts/profile_epilogue_overlap.py.

  python scripts/profile_torch_epilogue_overlap.py [--iters 10]
      [--out chiprun_out/profile_torch_epilogue_overlap.json]

Variants over (2^20, 256), 11 layers, through the hand-written CUDA kernel
ops/csrc/mxu_chain.cu (wgmma), on the JAX script's draw (W ~ N(0, 1/256),
f ~ N(30, 15^2); timing does not depend on the values), at each (tile T,
interleave k) the kernel takes, (64, 1), (128, 1) and (128, 2):
  chain_t64, chain_t128, ilv2_t128
                     the chain without epilogue, the yardsticks
  epi_ilv{k}_t{T}    a <- bf16(fast_sin(f * (a @ W + b) + p))
  fold_ilv{k}_t{T}   the folded form fast_sin(a @ bf16(W * bf16(f)) +
                     (f * b + p)): one add and the sine per element

Prints each variant's ms (CUDA events), TFLOP/s, its bound (the products
at the bf16 tensor-core peak) and, for the epilogue variants, the time the
epilogue adds over the chain at the same tile and interleave; writes them
with the card's name and power limit to --out. Needs CUDA.
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
    ap.add_argument("--out",
                    default="chiprun_out/profile_torch_epilogue_overlap.json")
    args = ap.parse_args(argv)
    dev = probes.require_cuda("profile_torch_epilogue_overlap")
    card = probes.card()
    print(card, flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    n, h, layers = probes.N_PTS, probes.H, probes.LAYERS
    x = probes.activations(gen, n, h, dev)
    w, b, f, p = probes.film_inputs(gen, layers, h, dev, "script")
    flops, nbytes = probes.chain_cost(n, h, layers)
    res = {}

    def run(name, fn):
        res[name] = probes.report(name, probes.time_ms(fn, args.iters),
                                  flops, nbytes, rows=n)
        return res[name]

    for tile, k in mxu_chain.VARIANTS:
        run(probes.chain_variant(tile, k),
            lambda: mxu_chain.run_chain(x, w, tile, interleave=k))
    for fold in (False, True):
        for tile, k in mxu_chain.VARIANTS:
            name = f"{'fold' if fold else 'epi'}_ilv{k}_t{tile}"
            rec = run(name, lambda: mxu_chain.run_epi(
                x, w, b, f, p, tile, interleave=k, fold=fold))
            base = probes.chain_variant(tile, k)
            rec["epilogue_ms"] = rec["ms"] - res[base]["ms"]
            print(f"{name}: the epilogue adds {rec['epilogue_ms']:.4f} ms "
                  f"to {base}", flush=True)
    probes.write_json(args.out, {"card": card,
                                 "iters": args.iters, "variants": res})
    return 0


if __name__ == "__main__":
    sys.exit(main())
