"""The field's ceiling probes: the Python side of the CUDA kernels in
ops/csrc/mxu_chain.cu (ports of the Pallas kernels
scripts/profile_mxu_chain.py::run_chain and
scripts/profile_epilogue_overlap.py::run_epi, on wgmma) and
ops/csrc/mxu_wide.cu (scripts/profile_mxu_chain.py::run_wide, on wgmma
with A from shared memory).

  run_chain / run_wide   a <- bf16(a @ W[i]) for every layer: the fused
                         field's chain of products alone (run_wide is the
                         same function, run by the probe scripts at width 512)
  run_epi                a <- bf16(fast_sin(f[i] * (a @ W[i] + b[i]) + p[i]));
                         with fold, a <- bf16(fast_sin(a @ bf16(W[i] *
                         bf16(f[i])) + (f[i] * b[i] + p[i])))

Products take bf16 operands with f32 accumulation; every layer's output is
rounded to bf16 (round to nearest even). run_chain and run_epi take widths
that are a multiple of 64 up to 256 and (tile, interleave) in VARIANTS:
(64, 1) a consumer warpgroup per 64-row tile and weight stage, (128, 1)
both consumers on one 128-row tile and every weight stage, (128, 2) the
same with the two consumers one pass apart (the TPU kernel's k-way row
interleave). run_wide takes widths that are a multiple of 64 up to 512 and
tiles in WIDE_TILES (the same two schedules as (64, 1) and (128, 1)).
Neither tile nor interleave changes the result.

Both kernels read the weights in one device layout (ops/csrc/
chain_pack.cuh), written by their pack kernel in the same call;
`pack_chain_weights` is the plain torch version of that pack (the same
bytes).

Dispatch: a wrapper checks its inputs, runs its plain version
(`chain_reference`, `epi_reference`) for CPU tensors and the CUDA kernel
for CUDA tensors, or raises; it never falls back. Weights are a sequence
of (h, h) bf16 tensors, as the JAX scripts pass them, or one (layers, h, h)
tensor.
"""
from __future__ import annotations

import ctypes

import torch

from fenerf_tpu_torch.ops import build
from fenerf_tpu_torch.ops.fast_math import fast_sin

VARIANTS = ((64, 1), (128, 1), (128, 2))   # (tile, interleave) of run_chain
MAX_WIDTH = 256
WIDE_TILES = (64, 128)
MAX_WIDE_WIDTH = 512
MAX_SMEM = 232_448      # a CTA's dynamic shared memory on an H100
_EPI = {"none": 0, "film": 1, "fold": 2}
# ops/csrc/chain_pack.cuh and mxu_chain.cu
PASS, KCHUNK, MAX_STAGES, MIN_STAGES = 128, 64, 8, 6
# ops/csrc/mxu_wide.cu: two weight stages per ring at tile 64
WIDE_MIN_STAGES = 4
# ops/csrc/chain.cuh (dma_gather.cu's overlap)
_KC, _WM, _WN = 32, 32, 64


def _align(x: int, a: int) -> int:
    return (x + a - 1) // a * a


def padded_width(h: int) -> int:
    """The output columns the wgmma kernels compute per layer: h rounded up
    to whole passes of PASS; the padded columns have zero weights."""
    return _align(h, PASS)


def _chain_layout(h: int, layers: int, epi: str) -> tuple[int, int]:
    """(stages, dynamic shared memory with the 1024-byte alignment slack)
    of ops/csrc/mxu_chain.cu::make_layout: barriers, weight stages of
    PASS x KCHUNK bf16, the two consumers' 64-row x tiles, the epilogue's
    vectors of every layer."""
    n_vec = {"none": 0, "film": 3, "fold": 1}[epi]
    x_bytes = 2 * 64 * h * 2
    epi_bytes = _align(n_vec * layers * padded_width(h) * 4, 128)
    max_smem = MAX_SMEM - 1024
    stages = min(MAX_STAGES,
                 (max_smem - 1024 - x_bytes - epi_bytes) // (PASS * KCHUNK * 2))
    total = 1024 + stages * PASS * KCHUNK * 2 + x_bytes + epi_bytes
    return stages, total + 1024


def chain_stages(h: int, layers: int, epi: str = "none") -> int:
    """The wgmma kernel's weight stages (mxu_chain.cu::mxu_chain_stages)."""
    return _chain_layout(h, layers, epi)[0]


def chain_smem(h: int, layers: int, epi: str = "none") -> int:
    """The wgmma kernel's shared memory per CTA
    (mxu_chain.cu::mxu_chain_smem)."""
    return _chain_layout(h, layers, epi)[1]


def group_smem(rows: int, h: int, warps: int) -> int:
    """Shared memory of one wmma warp group (ops/csrc/chain.cuh::
    group_layout): two activation buffers, two weight chunks, per-warp
    rounding tiles."""
    nc = warps // (rows // _WM) * _WN
    off = _align(rows * (h + 8) * 2, 128)
    off = _align(off + rows * (h + 8) * 2, 128)
    off = _align(off + _KC * (nc + 8) * 2, 128)
    off = _align(off + _KC * (nc + 8) * 2, 128)
    return _align(off + warps * 256 * 4, 128)


def _wide_layout(h: int) -> tuple[int, int]:
    """(stages, dynamic shared memory with the 1024-byte alignment slack)
    of ops/csrc/mxu_wide.cu::make_layout: barriers, weight stages of
    PASS x KCHUNK bf16, the two consumers' 64-row A tiles. The layout is
    the same at both tiles; tile 64 splits the stages into two rings."""
    a_bytes = 2 * 64 * h * 2
    stages = min(MAX_STAGES, (MAX_SMEM - 2048 - a_bytes)
                 // (PASS * KCHUNK * 2))
    return stages, 1024 + stages * PASS * KCHUNK * 2 + a_bytes + 1024


def wide_stages(h: int) -> int:
    """run_wide's weight stages (mxu_wide.cu::mxu_wide_stages)."""
    return _wide_layout(h)[0]


def wide_smem(h: int) -> int:
    """A run_wide CTA's shared memory (mxu_wide.cu::mxu_wide_smem)."""
    return _wide_layout(h)[1]


def _stack(ws, h: int, device, name: str) -> torch.Tensor:
    w = ws if isinstance(ws, torch.Tensor) else torch.stack(list(ws))
    if w.dtype != torch.bfloat16 or w.dim() != 3 or w.shape[0] < 1 \
            or tuple(w.shape[1:]) != (h, h) or w.device != device:
        raise ValueError(
            f"{name}: ws must be (h, h) bfloat16 weights (or one (layers, h, "
            f"h) tensor) on {device} with h = {h}; got {w.dtype} "
            f"{tuple(w.shape)} on {w.device}")
    return w.contiguous()


def _check_x(name: str, x: torch.Tensor, max_width: int) -> None:
    if x.dtype != torch.bfloat16 or x.dim() != 2 or not x.is_contiguous() \
            or x.shape[0] < 1:
        raise ValueError(f"{name}: x must be a contiguous (n, h) bfloat16 "
                         f"tensor with n >= 1; got {x.dtype} "
                         f"{tuple(x.shape)} (contiguous={x.is_contiguous()})")
    h = x.shape[1]
    if h % 64 or not 64 <= h <= max_width:
        raise ValueError(f"{name}: width h={h} not covered (a multiple of "
                         f"64, at most {max_width}; run_chain and run_epi "
                         f"take up to {MAX_WIDTH}, run_wide up to "
                         f"{MAX_WIDE_WIDTH})")


def _check(name: str, x: torch.Tensor, ws, tile: int, interleave: int,
           epi: str = "none") -> torch.Tensor:
    """Raise on what the wgmma kernel does not take; return the stacked
    weights."""
    _check_x(name, x, MAX_WIDTH)
    if (tile, interleave) not in VARIANTS:
        raise ValueError(f"{name}: tile {tile} / interleave {interleave} not "
                         f"covered ((tile, interleave) in {VARIANTS})")
    h = x.shape[1]
    w = _stack(ws, h, x.device, name)
    layers = w.shape[0]
    if chain_stages(h, layers, epi) < MIN_STAGES:
        raise ValueError(f"{name}: {layers} layers at width {h} leave "
                         f"{chain_stages(h, layers, epi)} weight stages in "
                         f"shared memory (at least {MIN_STAGES})")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError(f"{name}: x must start on a 16-byte boundary (one "
                         "bulk copy per tile)")
    return w


def _check_wide(x: torch.Tensor, ws, tile: int) -> torch.Tensor:
    """Raise on what run_wide's kernel does not take; return the stacked
    weights."""
    _check_x("run_wide", x, MAX_WIDE_WIDTH)
    if tile not in WIDE_TILES:
        raise ValueError(f"run_wide: tile {tile} not covered (one of "
                         f"{WIDE_TILES}: wgmma has no row group under 64)")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError("run_wide: x must start on a 16-byte boundary "
                         "(its tiles come in by 2-D tensor copies)")
    return _stack(ws, x.shape[1], x.device, "run_wide")


def _check_film(x: torch.Tensor, layers: int, **vecs) -> None:
    for key, v in vecs.items():
        if v.dtype != torch.float32 or tuple(v.shape) != (layers, x.shape[1]) \
                or not v.is_contiguous() or v.device != x.device:
            raise ValueError(
                f"run_epi: {key} must be a contiguous ({layers}, "
                f"{x.shape[1]}) float32 tensor on {x.device}; got {v.dtype} "
                f"{tuple(v.shape)} on {v.device}")


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round f32 to bf16 and hold it in f32 again (T1: products of bf16
    values in f32, never a bf16 matmul in torch)."""
    return t.to(torch.bfloat16).float()


def chain_reference(x: torch.Tensor, ws) -> torch.Tensor:
    """The plain torch version of run_chain / run_wide: bf16 values held in
    f32, an f32 product, rounded to bf16 after every layer."""
    chain_reference.calls += 1
    a = x.float()
    for w in ws:
        a = _bf16(a @ w.float())
    return a.to(torch.bfloat16)


chain_reference.calls = 0


def epi_reference(x: torch.Tensor, ws, bs: torch.Tensor, f: torch.Tensor,
                  p: torch.Tensor, fold: bool = False) -> torch.Tensor:
    """The plain torch version of run_epi, in the JAX kernel's order
    (scripts/profile_epilogue_overlap.py:64-82): with fold, the scaled
    weights bf16(W * bf16(f)) are formed in bf16 (the product of two bf16
    values is exact in f32, so rounding it once gives the bf16 product)."""
    epi_reference.calls += 1
    a = x.float()
    for i, w in enumerate(ws):
        if fold:
            y = a @ _bf16(w.float() * _bf16(f[i]))
            a = _bf16(fast_sin(y + (f[i] * bs[i] + p[i])))
        else:
            a = _bf16(fast_sin(f[i] * (a @ w.float() + bs[i]) + p[i]))
    return a.to(torch.bfloat16)


epi_reference.calls = 0


def pack_chain_weights(w: torch.Tensor, b: torch.Tensor | None = None,
                       f: torch.Tensor | None = None,
                       p: torch.Tensor | None = None, fold: bool = False):
    """The plain torch version of chain_pack.cuh's pack kernel: (wdev, q).

    wdev, flat bf16: for every layer, every PASS-column pass of the padded
    width (h rounded up to a multiple of PASS) and every 64-row K chunk,
    PASS rows (one per output column n) of 64 K values, the 16-byte group
    q of row r holding K values 8 * (q ^ (r % 8)) .. + 8 of the chunk
    (wgmma's 128-byte-swizzled K-major B operand); columns past h hold
    zeros. With fold the weights are bf16(W * bf16(f)) per output column
    and q = f * b + p, else q is None."""
    layers, h, _ = w.shape
    hd = padded_width(h)
    q = None
    if fold:
        fb = f.to(torch.bfloat16).float()
        w = (w.float() * fb[:, None, :]).to(torch.bfloat16)
        q = f * b + p
    bt = torch.zeros(layers, hd, h, dtype=torch.bfloat16, device=w.device)
    bt[:, :h] = w.transpose(1, 2)
    # [l][pass][r][chunk][group][e] -> [l][pass][chunk][r][position][e]
    t = bt.view(layers, hd // PASS, PASS, h // KCHUNK, 8, 8)
    t = t.permute(0, 1, 3, 2, 4, 5)
    r = torch.arange(PASS, device=w.device)[:, None]
    group = torch.arange(8, device=w.device)[None, :] ^ (r & 7)
    return t[:, :, :, r, group].reshape(-1), q


_LIBS: dict = {}


def _load_library(name: str = "mxu_chain"):
    """ops/csrc/<name>.cu (mxu_chain or mxu_wide), built for sm_90a into
    build/ and loaded."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = build.library(name)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        if name == "mxu_chain":
            lib.mxu_chain_forward.argtypes = [vp] * 8 + [ci] * 6 + [vp]
            lib.mxu_chain_forward.restype = ci
            lib.mxu_chain_pack.argtypes = [vp] * 6 + [ci] * 3 + [vp]
            lib.mxu_chain_pack.restype = ci
            for fn in (lib.mxu_chain_smem, lib.mxu_chain_stages):
                fn.argtypes = [ci] * 3
                fn.restype = ci
        else:
            lib.mxu_wide_forward.argtypes = [vp] * 4 + [ci] * 4 + [vp]
            lib.mxu_wide_forward.restype = ci
            lib.mxu_wide_pack.argtypes = [vp] * 2 + [ci] * 2 + [vp]
            lib.mxu_wide_pack.restype = ci
            for fn in (lib.mxu_wide_smem, lib.mxu_wide_stages):
                fn.argtypes = [ci]
                fn.restype = ci
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ci]
        err.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def _raise(lib, name: str, fn: str, rc: int) -> None:
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{fn} kernel launch failed: {msg} ({rc})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _scratch(w: torch.Tensor, fold: bool):
    """The pack's outputs: the device layout and, with fold, q."""
    layers, h, _ = w.shape
    wdev = torch.empty(layers * padded_width(h) * h, dtype=torch.bfloat16,
                       device=w.device)
    q = torch.empty(layers, h, device=w.device) if fold else None
    return wdev, q


def pack_on_device(w: torch.Tensor, b=None, f=None, p=None,
                   fold: bool = False):
    """The pack kernel alone on CUDA tensors: (wdev, q), the bytes
    pack_chain_weights writes; mxu_chain's up to width 256, mxu_wide's
    (no fold) above."""
    layers, h, _ = w.shape
    wdev, q = _scratch(w, fold)
    if h <= MAX_WIDTH:
        lib = _load_library()
        _raise(lib, "mxu_chain", "mxu_chain_pack", lib.mxu_chain_pack(
            w.data_ptr(), _ptr(b), _ptr(f), _ptr(p), wdev.data_ptr(),
            _ptr(q), h, layers, int(fold), _stream(w)))
    elif fold:
        raise ValueError(f"pack_on_device: no folded pack at width {h} "
                         f"(run_epi takes up to {MAX_WIDTH})")
    else:
        lib = _load_library("mxu_wide")
        _raise(lib, "mxu_wide", "mxu_wide_pack", lib.mxu_wide_pack(
            w.data_ptr(), wdev.data_ptr(), h, layers, _stream(w)))
    return wdev, q


def _launch(name, x, w, tile, interleave, epi="none", b=None, f=None,
            p=None) -> torch.Tensor:
    n, h = x.shape
    out = torch.empty_like(x)
    wdev, q = _scratch(w, epi == "fold")
    lib = _load_library()
    _raise(lib, "mxu_chain", name, lib.mxu_chain_forward(
        x.data_ptr(), w.data_ptr(), _ptr(b), _ptr(f), _ptr(p),
        wdev.data_ptr(), _ptr(q), out.data_ptr(), n, h, w.shape[0], tile,
        interleave, _EPI[epi], _stream(x)))
    return out


def _device(name: str, x: torch.Tensor) -> bool:
    """True for CUDA (launch), False for the CPU (plain version)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return x.device.type == "cuda"


def run_chain(x: torch.Tensor, ws, tile: int = 64,
              interleave: int = 1) -> torch.Tensor:
    """x (n, h) bf16 through the bf16 chain of ws; (n, h) bf16."""
    w = _check("run_chain", x, ws, tile, interleave)
    if not _device("run_chain", x):
        return chain_reference(x, w)
    out = _launch("run_chain", x, w, tile, interleave)
    run_chain.launches += 1
    return out


run_chain.launches = 0


def run_wide(x: torch.Tensor, ws, tile: int = 128) -> torch.Tensor:
    """The same chain as run_chain at widths up to 512, on mxu_wide.cu's
    wgmma kernel with A from shared memory (the probe scripts run it at
    width 512, 5 layers: the FLOPs per point of the 11-layer chain at
    256)."""
    w = _check_wide(x, ws, tile)
    if not _device("run_wide", x):
        return chain_reference(x, w)
    out = torch.empty_like(x)
    wdev, _ = _scratch(w, False)
    lib = _load_library("mxu_wide")
    _raise(lib, "mxu_wide", "run_wide", lib.mxu_wide_forward(
        x.data_ptr(), w.data_ptr(), wdev.data_ptr(), out.data_ptr(),
        x.shape[0], x.shape[1], w.shape[0], tile, _stream(x)))
    run_wide.launches += 1
    return out


run_wide.launches = 0


def run_epi(x: torch.Tensor, ws, bs: torch.Tensor, f: torch.Tensor,
            p: torch.Tensor, tile: int = 64, interleave: int = 1,
            fold: bool = False) -> torch.Tensor:
    """x (n, h) bf16 through the FiLM-sine chain (bs, f, p: (layers, h)
    f32); (n, h) bf16."""
    epi = "fold" if fold else "film"
    w = _check("run_epi", x, ws, tile, interleave, epi)
    _check_film(x, w.shape[0], bs=bs, f=f, p=p)
    if not _device("run_epi", x):
        return epi_reference(x, w, bs, f, p, fold=fold)
    out = _launch("run_epi", x, w, tile, interleave, epi, bs, f, p)
    run_epi.launches += 1
    return out


run_epi.launches = 0
