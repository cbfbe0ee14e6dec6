"""Where the wgmma chains' time goes, by removal, on one NVIDIA GPU.

  python scripts/profile_torch_chain_ablate.py [--iters 20] [--reps 2]
      [--out chiprun_out/profile_torch_chain_ablate.json]

Builds copies of ops/csrc/mxu_chain.cu and ops/csrc/mxu_wide.cu, each with
one part taken out, into build/chain_ablate/ and times them against the
unchanged kernel in one process, in turns (base, variants..., variants
reversed, base), tiles 64 and 128. mxu_chain.cu at its probe shape (2^20 x
256, 11 layers, the JAX script's draw; keys chain_<variant>_<epilogue>_t<T>):

  base      the kernel as it is
  noload    layer 0's A fragments not read from the x tile in shared memory
  nostore   the last layer not stored
  nomma     no wgmma issued (the weight ring, waits and epilogues remain)
  nosin     the FiLM epilogue without its sine (run_epi only)

mxu_wide.cu at its probe shape (2^19 x 512, 5 layers; keys
wide_<variant>_t<T>):

  base      the kernel as it is
  noload    no x tile copied in (its barriers arrive without bytes)
  nostore   no output copied out
  noputa    no layer's output written over the A tile (the stores stay
            in the code behind a condition false at run time)
  nowt      no weight chunk copied (the ring's barriers arrive without
            bytes; the products read whatever the stages hold)
  nomma     no wgmma issued (the copies, waits and write-backs remain)

The variants compute wrong results by design; only their times mean
anything. Prints the median ms of each and writes them with the card's name
and power limit to --out. Needs CUDA and nvcc.
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
            raise RuntimeError(f"the kernel source changed; not found: "
                               f"{ln!r}")
        src = src.replace(ln, "")
    return src


def chain_variants(src: str) -> dict[str, str]:
    """mxu_chain.cu's source with each part removed."""
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


def wide_variants(src: str) -> dict[str, str]:
    """mxu_wide.cu's source with each part removed."""
    def swap(text: str, old: str, new: str) -> str:
        if old not in text:
            raise RuntimeError(f"mxu_wide.cu changed; not found: {old!r}")
        return text.replace(old, new)

    load = ("          mbar_arrive_expect_tx(&xf[b], BLOCK_BYTES);\n"
            "          tma_load_2d(a + b * BLOCK_BYTES, &tmx, b * KCHUNK, "
            "row0, &xf[b]);\n")
    copy = ("          mbar_arrive_expect_tx(&full[ring0 + s], STAGE_BYTES);\n"
            "          bulk_copy_g2s(smem + L.off_w + (size_t)(ring0 + s) * "
            "STAGE_BYTES,\n"
            "                        wdev + (size_t)g * PASS * KCHUNK, "
            "STAGE_BYTES,\n"
            "                        &full[ring0 + s]);\n")
    store = "tma_store_2d(&tmo, b * KCHUNK, prev, a + b * BLOCK_BYTES);\n"
    return {
        "base": src,
        "noload": swap(src, load, "          mbar_arrive(&xf[b]);\n"),
        "nostore": swap(src, store, "\n"),
        # the write-backs kept but never taken: deleting them would leave
        # the products' results unused, and ptxas drops unused products
        "noputa": swap(src, "    if (j >= j0 && j < j1 && col < h) {\n",
                       "    if (j >= j0 && j < j1 && col < h && h < 0) {\n"),
        "nowt": swap(src, copy,
                     "          mbar_arrive(&full[ring0 + s]);\n"),
        "nomma": _without(
            src, "    Wgmma<PASS>::template ss<0, 0>(acc, desc_sw128(a, 16, "
                 "1024),\n                                   desc_sw128(b, "
                 "16, 1024), kb);\n"),
    }


def build_all(srcs: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """One nvcc per variant (keys chain_<name> / wide_<name>), all at
    once."""
    out = ROOT / "build" / "chain_ablate"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in srcs.items():
        (out / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            build.command(out / f"{name}.cu", out / f"{name}.so"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        if name.startswith("chain_"):
            lib.mxu_chain_forward.argtypes = [vp] * 8 + [ci] * 6 + [vp]
            lib.mxu_chain_forward.restype = ci
        else:
            lib.mxu_wide_forward.argtypes = [vp] * 4 + [ci] * 4 + [vp]
            lib.mxu_wide_forward.restype = ci
        libs[name] = lib
    return libs


def launch_wide(lib, x, w, tile) -> torch.Tensor:
    out = torch.empty_like(x)
    wdev, _ = mxu_chain._scratch(w, False)
    rc = lib.mxu_wide_forward(
        x.data_ptr(), w.data_ptr(), wdev.data_ptr(), out.data_ptr(),
        x.shape[0], x.shape[1], w.shape[0], tile,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed ({rc})")
    return out


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
    srcs = {f"chain_{k}": v for k, v in chain_variants(
        (build.CSRC / "mxu_chain.cu").read_text()).items()}
    srcs.update({f"wide_{k}": v for k, v in wide_variants(
        (build.CSRC / "mxu_wide.cu").read_text()).items()})
    libs = build_all(srcs)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = probes.activations(gen, probes.N_PTS, probes.H, dev)
    w, b, f, p = probes.film_inputs(gen, probes.LAYERS, probes.H, dev)
    times: dict[str, list[float]] = {}
    chain = [k for k in libs if k.startswith("chain_")]
    for _ in range(args.reps):
        for name in chain + chain[::-1]:
            for epi in (0, 1):        # none, FiLM
                if name == "chain_nosin" and epi == 0:
                    continue
                for tile in TILES:
                    key = f"{name}_{'film' if epi else 'none'}_t{tile}"
                    times.setdefault(key, []).append(probes.time_ms(
                        lambda: launch(libs[name], x, w, tile, epi, b, f, p),
                        args.iters))
    del x, w, b, f, p
    x, w = probes.chain_inputs(gen, probes.WIDE_N, probes.WIDE_H,
                               probes.WIDE_LAYERS, dev)
    wide = [k for k in libs if k.startswith("wide_")]
    for _ in range(args.reps):
        for name in wide + wide[::-1]:
            for tile in TILES:
                times.setdefault(f"{name}_t{tile}", []).append(
                    probes.time_ms(lambda: launch_wide(libs[name], x, w,
                                                       tile), args.iters))
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
