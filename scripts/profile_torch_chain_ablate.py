"""Where the wgmma chain's time goes, by removal, on one NVIDIA GPU.

  python scripts/profile_torch_chain_ablate.py [--iters 20] [--reps 2]
      [--out chiprun_out/profile_torch_chain_ablate.json]

Builds copies of ops/csrc/mxu_chain.cu, each with one part taken out, into
build/chain_ablate/ and times them against the unchanged kernel in one
process, in turns (base, variants..., variants reversed, base), at the probe
shape (2^20 x 256, 11 layers, the JAX script's draw), tiles 64 and 128:

  base      the kernel as it is
  noload    layer 0's A fragments not read from the x tile in shared memory
  nostore   the last layer not stored
  nomma     no wgmma issued (the weight ring, waits and epilogues remain)
  nosin     the FiLM epilogue without its sine (run_epi only)

The variants compute wrong results by design; only their times mean
anything. Prints the median ms of each (variant, epilogue, tile) and writes
them with the card's name and power limit to --out. Needs CUDA and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from fenerf_tpu_torch.ops import build, mxu_chain, probes  # noqa: E402

TILES = (64, 128)


def _without(src: str, *lines: str) -> str:
    for ln in lines:
        if ln not in src:
            raise RuntimeError(f"mxu_chain.cu changed; not found: {ln!r}")
        src = src.replace(ln, "")
    return src


def variants(src: str) -> dict[str, str]:
    """The kernel's source with each part removed."""
    loads = [f"      frag[4 * j{o}] = *reinterpret_cast<const uint32_t*>({p});\n"
             for o, p in (("", "lo"), (" + 1", "hi"), (" + 2", "lo + 8"),
                          (" + 3", "hi + 8"))]
    nostore = src
    for side in ("lo", "hi"):
        old = f"        if (ok_{side}) {{"
        if old not in nostore:
            raise RuntimeError(f"mxu_chain.cu changed; not found: {old!r}")
        nostore = nostore.replace(old, f"        if (ok_{side} && n < 0) {{")
    a = src.index("__device__ __forceinline__ void epilogue(")
    b = src.index("template <int EPI>\n__global__")
    return {
        "base": src,
        "noload": _without(src, *loads),
        "nostore": nostore,
        "nomma": _without(src, "    Wgmma<PASS>::template rs<0>(acc, a, "
                               "desc_sw128(addr, 16, 1024), kb);\n"),
        "nosin": src[:a] + src[a:b].replace("fast_sin(", "(") + src[b:],
    }


def build_all(srcs: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """One nvcc per variant, all at once."""
    out = ROOT / "build" / "chain_ablate"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in srcs.items():
        (out / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            build.command(out / f"{name}.cu", out / f"{name}.so"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.mxu_chain_forward.argtypes = [vp] * 8 + [ci] * 6 + [vp]
        lib.mxu_chain_forward.restype = ci
        libs[name] = lib
    return libs


def launch(lib, x, w, tile, epi, b, f, p) -> torch.Tensor:
    out = torch.empty_like(x)
    wdev, _ = mxu_chain._scratch(w, False)
    vec = (b, f, p) if epi else (None,) * 3
    rc = lib.mxu_chain_forward(
        x.data_ptr(), w.data_ptr(), *(v if v is None else v.data_ptr()
                                      for v in vec),
        wdev.data_ptr(), None, out.data_ptr(), x.shape[0], x.shape[1],
        w.shape[0], tile, 1, epi, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed ({rc})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out",
                    default="chiprun_out/profile_torch_chain_ablate.json")
    args = ap.parse_args(argv)
    dev = probes.require_cuda("profile_torch_chain_ablate")
    card = probes.card()
    print(card, flush=True)
    libs = build_all(variants((build.CSRC / "mxu_chain.cu").read_text()))
    gen = torch.Generator(device=dev).manual_seed(0)
    x = probes.activations(gen, probes.N_PTS, probes.H, dev)
    w, b, f, p = probes.film_inputs(gen, probes.LAYERS, probes.H, dev)
    times: dict[str, list[float]] = {}
    order = list(libs) + list(libs)[::-1]
    for _ in range(args.reps):
        for name in order:
            for epi in (0, 1):        # none, FiLM
                if name == "nosin" and epi == 0:
                    continue
                for tile in TILES:
                    key = f"{name}_{'film' if epi else 'none'}_t{tile}"
                    times.setdefault(key, []).append(probes.time_ms(
                        lambda: launch(libs[name], x, w, tile, epi, b, f, p),
                        args.iters))
    res = {}
    for key, ms in sorted(times.items()):
        res[key] = {"median_ms": statistics.median(ms), "ms": ms}
        print(f"{key}: median {res[key]['median_ms']:.4f} ms of "
              + " ".join(f"{m:.4f}" for m in ms), flush=True)
    probes.write_json(args.out, {"card": card, "iters": args.iters,
                                 "variants": res})
    return 0


if __name__ == "__main__":
    sys.exit(main())
