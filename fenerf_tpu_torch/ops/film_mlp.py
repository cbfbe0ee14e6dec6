"""Fused FiLM-SIREN field forward: the Python side of the CUDA kernel
(port of the Pallas kernel fenerf_tpu/ops/film_mlp.py::film_mlp).

One kernel evaluates the whole field for a tile of points: the trunk FiLM
layers, the packed [sigma | folded label chain] head, the color FiLM layers
over [ray_dir | grid feats | x] and the rgb head, keeping every activation
on chip. Every matmul operand is rounded to bf16 and accumulated in f32;
bias, FiLM and the polynomial sine run in f32.

The field is described to the kernel as a short PROGRAM of layers
(`pack`): each layer sums up to three row segments read from on-chip
buffers (the input tile [points | dirs | grid feats], or a hidden-wide
activation buffer), multiplies by its zero-padded bf16 weight block, and
ends in one epilogue: FiLM sine into a buffer, a plain linear into a
buffer, or a linear (optionally sigmoid) scattered into output columns.
The same program drives both the kernel and its plain torch version
`film_mlp_reference`, so the CPU parity tests against the JAX kernel check
the packing that the card runs.

Dispatch: `film_mlp` runs `film_mlp_reference` for CPU tensors and the
CUDA kernel for CUDA tensors (or raises); it never falls back.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Any

import torch

from fenerf_tpu_torch.nn.fields import FieldConfig
from fenerf_tpu_torch.ops import build
from fenerf_tpu_torch.ops.fast_math import fast_sin

# on-chip buffers a layer reads or writes (ops/csrc/film_mlp.cu)
BUF_IN, BUF_A, BUF_B = 0, 1, 2
# input tile columns: points [0, 3), dirs [16, 19), grid feats [32, 32+G)
IN_PTS, IN_DIRS, IN_GRID = 0, 16, 32
# epilogues
FILM, LIN_BUF, LIN_OUT = 0, 1, 2
LAYER_INTS = 24

PACK_KEY = "film_pack"


def _pad16(n: int) -> int:
    return (n + 15) // 16 * 16


def supported(cfg: Any) -> bool:
    """Variants the fused field covers (as in the JAX package): all film
    variants except the two exotic color-branch rewirings."""
    if not isinstance(cfg, FieldConfig):
        return False
    return (not cfg.color_pre_dim and not cfg.res_sigma
            and cfg.hidden_dim % 16 == 0 and cfg.hidden_dim <= 256
            and cfg.output_dim <= 256)


def supported_train(cfg: Any) -> bool:
    """Variants the fused backward (ops/film_mlp_grad.py) covers, as in the
    JAX package: the forward's, with ray directions, without grid features
    in the trunk and without a FiLM label head."""
    return (supported(cfg) and cfg.use_ray_dir
            and not (cfg.grid_channels and cfg.grid_to == "trunk")
            and not cfg.label_film)


def backend_for(cfg: Any, device, train: bool = False) -> str:
    """THE film-family dispatch policy: on CUDA and for a covered variant,
    'kernel' (forward only) or, with train=True, 'kernel_train' (fused
    forward and backward); else the layer-by-layer 'torch' path."""
    if torch.device(device).type != "cuda":
        return "torch"
    if train:
        return "kernel_train" if supported_train(cfg) else "torch"
    return "kernel" if supported(cfg) else "torch"


def _fold_heads(cfg: FieldConfig) -> bool:
    """The label head is a chain of linears with no activation between
    them, so it folds to one (h, n_labels) matmul, and with the sigma head
    (same input) to one (h, 1 + n_labels) pass. label_film variants put a
    FiLM sine before the label linears and keep the chain."""
    return bool(cfg.n_labels) and not cfg.label_film


@dataclasses.dataclass
class _Layer:
    segs: list            # [(buffer, first column, real rows)]
    w: torch.Tensor       # (sum of real rows, n) f32, rows in segment order
    b: torch.Tensor       # (n,) f32
    kind: int
    dst: int = BUF_A
    film: int = 0         # 0: geometry film, 1: appearance film
    chunk: int = 0
    # LIN_OUT: columns [0, split) -> out0.., [split, n) -> out1..
    split: int = 0
    out0: int = 0
    sig0: bool = False
    out1: int = 0
    sig1: bool = False


@dataclasses.dataclass
class FilmPack:
    """Kernel operands of one parameter set: the layer program (int32,
    LAYER_INTS per layer), all weights zero-padded and flattened in bf16,
    all biases padded and flattened in f32."""
    cfg: FieldConfig
    program: torch.Tensor
    weights: torch.Tensor
    biases: torch.Tensor
    n_layers: int
    in_width: int
    n_bufs: int
    max_n_pad: int
    l_geo: int
    l_app: int


def _layers(params: Any, cfg: FieldConfig) -> list[_Layer]:
    h = cfg.hidden_dim
    g = cfg.grid_channels or 0
    g_col = g if cfg.grid_to == "color" else 0
    g_trunk = g if cfg.grid_to == "trunk" else 0
    lf = 1 if (cfg.n_labels and cfg.label_film) else 0
    f32 = lambda t: t.to(torch.float32)
    out = []

    # trunk: first-layer rows are [grid(G) | points(3)] for grid_to='trunk'
    for i, lyr in enumerate(params["trunk"]):
        if i == 0:
            segs = ([(BUF_IN, IN_GRID, g_trunk)] if g_trunk else []) \
                + [(BUF_IN, IN_PTS, 3)]
        else:
            segs = [(BUF_A, 0, h)]
        out.append(_Layer(segs, f32(lyr["w"]), f32(lyr["b"]), FILM,
                          dst=BUF_A, film=0, chunk=i))

    # heads read the trunk output x before the color branch overwrites it
    sigma_col = cfg.output_dim - 1
    if _fold_heads(cfg):
        # label chain folded in f32, then ONE bf16 rounding of the result
        w = f32(params["label_head"][0]["w"])
        b = f32(params["label_head"][0]["b"])
        for lyr in params["label_head"][1:]:
            w2 = f32(lyr["w"])
            b = b @ w2 + f32(lyr["b"])
            w = w @ w2
        packed_w = torch.cat([f32(params["sigma_head"]["w"]), w], dim=1)
        packed_b = torch.cat([f32(params["sigma_head"]["b"]), b])
        out.append(_Layer([(BUF_A, 0, h)], packed_w, packed_b, LIN_OUT,
                          split=1, out0=sigma_col, out1=0,
                          sig1=cfg.label_sigmoid))
    else:
        out.append(_Layer([(BUF_A, 0, h)], f32(params["sigma_head"]["w"]),
                          f32(params["sigma_head"]["b"]), LIN_OUT,
                          split=1, out0=sigma_col))
        if cfg.n_labels:
            src = BUF_A
            if lf:  # the label branch's own FiLM layer, app chunk 0
                p = params["label_film"]
                out.append(_Layer([(BUF_A, 0, h)], f32(p["w"]), f32(p["b"]),
                                  FILM, dst=BUF_B, film=1, chunk=0))
                src = BUF_B
            chain = params["label_head"]
            for j, lyr in enumerate(chain):
                if j < len(chain) - 1:
                    out.append(_Layer([(src, 0, h)], f32(lyr["w"]),
                                      f32(lyr["b"]), LIN_BUF, dst=BUF_B))
                    src = BUF_B
                else:
                    n_lbl = cfg.n_labels
                    out.append(_Layer([(src, 0, h)], f32(lyr["w"]),
                                      f32(lyr["b"]), LIN_OUT, split=n_lbl,
                                      out0=0, sig0=cfg.label_sigmoid))

    # color branch: first-layer rows [ray_dir(3)? | grid(G)? | x(H)]
    for i, lyr in enumerate(params["color"]):
        if i == 0:
            segs = ([(BUF_IN, IN_DIRS, 3)] if cfg.use_ray_dir else []) \
                + ([(BUF_IN, IN_GRID, g_col)] if g_col else []) \
                + [(BUF_A, 0, h)]
        else:
            segs = [(BUF_A, 0, h)]
        out.append(_Layer(segs, f32(lyr["w"]), f32(lyr["b"]), FILM,
                          dst=BUF_A, film=1, chunk=lf + i))
    out.append(_Layer([(BUF_A, 0, h)], f32(params["color_head"]["w"]),
                      f32(params["color_head"]["b"]), LIN_OUT,
                      split=cfg.rgb_dim, out0=cfg.n_labels,
                      sig0=cfg.rgb_sigmoid))
    return out


def pack(params: Any, cfg: FieldConfig) -> FilmPack:
    """Fold, pad and flatten the field's MLP parameters into kernel
    operands on the parameters' device."""
    if not supported(cfg):
        raise ValueError(f"variant {cfg.name} is not covered by film_mlp")
    device = params["trunk"][0]["w"].device
    layers = _layers(params, cfg)
    prog, ws, bs = [], [], []
    w_off = b_off = 0
    for lyr in layers:
        n = lyr.w.shape[1]
        n_pad = _pad16(n)
        k_pads = [_pad16(k) for _, _, k in lyr.segs]
        wp = torch.zeros(sum(k_pads), n_pad, dtype=torch.float32,
                         device=device)
        r_real = r_pad = 0
        for (_, _, k), kp in zip(lyr.segs, k_pads):
            wp[r_pad:r_pad + k, :n] = lyr.w[r_real:r_real + k]
            r_real += k
            r_pad += kp
        assert r_real == lyr.w.shape[0], (lyr.segs, lyr.w.shape)
        bp = torch.zeros(n_pad, dtype=torch.float32, device=device)
        bp[:n] = lyr.b
        ws.append(wp.to(torch.bfloat16).reshape(-1))
        bs.append(bp)
        d = [0] * LAYER_INTS
        d[0] = len(lyr.segs)
        for s, ((src, col, _), kp) in enumerate(zip(lyr.segs, k_pads)):
            d[1 + 3 * s:4 + 3 * s] = [src, col, kp]
        d[10:24] = [n_pad, w_off, b_off, lyr.kind, lyr.dst, lyr.film,
                    lyr.chunk, n, lyr.split, lyr.out0, int(lyr.sig0),
                    lyr.out1, int(lyr.sig1), sum(k_pads)]
        prog.append(d)
        w_off += wp.numel()
        b_off += n_pad
    g = cfg.grid_channels or 0
    lf = 1 if (cfg.n_labels and cfg.label_film) else 0
    uses_b = any(lyr.dst == BUF_B for lyr in layers)
    return FilmPack(
        cfg=cfg,
        program=torch.tensor(prog, dtype=torch.int32, device=device),
        weights=torch.cat(ws), biases=torch.cat(bs), n_layers=len(layers),
        in_width=IN_GRID + _pad16(g) if g else IN_GRID,
        n_bufs=2 if uses_b else 1,
        max_n_pad=max(d[10] for d in prog),
        l_geo=cfg.trunk_layers, l_app=cfg.color_layers + lf)


def with_pack(params: Any, cfg: Any) -> Any:
    """`params` plus its FilmPack under PACK_KEY (derived, never
    checkpointed): pack once per loaded checkpoint or render, not once per
    ray block. No-op if a pack is present or the variant is not covered."""
    if PACK_KEY in params or not supported(cfg):
        return params
    return {**params, PACK_KEY: pack(params, cfg)}


def get_pack(params: Any, cfg: FieldConfig) -> FilmPack:
    found = params.get(PACK_KEY)
    return found if found is not None else pack(params, cfg)


def _film_tables(cfg: FieldConfig, l_geo: int, l_app: int, film_geo,
                 film_app, batch: int):
    """Raw (B, L*H) film -> transformed frequencies and phases (B, L, H),
    each a fresh contiguous tensor (the kernels read them 16 bytes at a
    time, so they must not be offset views)."""
    h = cfg.hidden_dim
    fg, pg = film_geo
    fa, pa = film_app
    fresh = lambda t, n: t.reshape(batch, n, h).clone(
        memory_format=torch.contiguous_format)
    return (fresh(fg * cfg.freq_scale + cfg.freq_offset, l_geo),
            fresh(pg, l_geo),
            fresh(fa * cfg.freq_scale + cfg.freq_offset, l_app),
            fresh(pa, l_app))


def film_mlp_reference(p: FilmPack, points: torch.Tensor,
                       ray_dirs: torch.Tensor,
                       grid_feats: torch.Tensor | None, film_geo,
                       film_app) -> torch.Tensor:
    """The plain torch version of the kernel: the same program, padded
    weights and roundings, layer by layer. (B, N, 3) points -> (B, N, out).
    Matmul operands are bf16 values held in f32 (a bf16 torch matmul would
    also round its result)."""
    film_mlp_reference.calls += 1
    b, n, _ = points.shape
    rows = b * n
    cfg = p.cfg
    g = cfg.grid_channels or 0
    bf = lambda t: t.to(torch.bfloat16).to(torch.float32)
    fg, pg, fa, pa = _film_tables(cfg, p.l_geo, p.l_app, film_geo, film_app,
                                  b)
    inb = points.new_zeros(rows, p.in_width)
    inb[:, IN_PTS:IN_PTS + 3] = points.reshape(rows, 3)
    inb[:, IN_DIRS:IN_DIRS + 3] = ray_dirs.reshape(rows, 3)
    if g:
        inb[:, IN_GRID:IN_GRID + g] = grid_feats.reshape(rows, g).float()
    bufs = {BUF_IN: bf(inb)}
    out = points.new_empty(rows, cfg.output_dim)
    for d in p.program.tolist():
        n_pad, w_off, b_off, kind, dst, film, chunk, n_valid, split, \
            out0, sig0, out1, sig1, k_total = d[10:24]
        x = torch.cat([bufs[d[1 + 3 * s]][:, d[2 + 3 * s]:
                                          d[2 + 3 * s] + d[3 + 3 * s]]
                       for s in range(d[0])], dim=1)
        w = p.weights[w_off:w_off + k_total * n_pad].reshape(k_total, n_pad)
        y = x @ w.float() + p.biases[b_off:b_off + n_pad]
        if kind == FILM:
            f = (fg if film == 0 else fa)[:, chunk][:, None, :]
            ph = (pg if film == 0 else pa)[:, chunk][:, None, :]
            y = fast_sin(f * y.reshape(b, n, n_pad) + ph).reshape(rows, n_pad)
            bufs[dst] = bf(y)
        elif kind == LIN_BUF:
            bufs[dst] = bf(y)
        else:
            for lo, hi, col, sig in ((0, split, out0, sig0),
                                     (split, n_valid, out1, sig1)):
                if hi > lo:
                    v = y[:, lo:hi]
                    out[:, col:col + hi - lo] = torch.sigmoid(v) if sig else v
    return out.reshape(b, n, cfg.output_dim)


film_mlp_reference.calls = 0


# ---------------------------------------------------------------------------
# The CUDA kernel: built with nvcc at first use (ops/build.py), bound with
# ctypes
# ---------------------------------------------------------------------------

_LIB = None


def _load_library():
    """ops/csrc/film_mlp.cu, built for sm_90a into build/ and loaded."""
    global _LIB
    if _LIB is None:
        lib = build.library("film_mlp")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.film_mlp_forward.argtypes = [vp] * 10 + [ci] * 11 + [vp, vp]
        lib.film_mlp_forward.restype = ci
        lib.film_mlp_error_string.argtypes = [ci]
        lib.film_mlp_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(t: torch.Tensor, name: str, shape, dtype, device,
           who: str = "film_mlp"):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{who}: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def film_mlp(p: FilmPack, points: torch.Tensor, ray_dirs: torch.Tensor,
             grid_feats: torch.Tensor | None, film_geo,
             film_app) -> torch.Tensor:
    """Fused field evaluation (B, N, 3) -> (B, N, output_dim) f32.

    CPU tensors take film_mlp_reference; CUDA tensors launch the sm_90a
    kernel (ops/csrc/film_mlp.cu) or raise."""
    if points.device.type == "cpu":
        return film_mlp_reference(p, points, ray_dirs, grid_feats, film_geo,
                                  film_app)
    if points.device.type != "cuda":
        raise ValueError(f"film_mlp: no kernel for device {points.device}")
    cfg = p.cfg
    dev = points.device
    b, n, _ = points.shape
    rows = b * n
    g = cfg.grid_channels or 0
    f32 = torch.float32
    _check(points, "points", (b, n, 3), f32, dev)
    _check(ray_dirs, "ray_dirs", (b, n, 3), f32, dev)
    for name, t in (("program", p.program), ("weights", p.weights),
                    ("biases", p.biases)):
        if t.device != dev:
            raise ValueError(f"film_mlp: pack {name} on {t.device}, "
                             f"points on {dev}")
    gf = None
    if g:
        if grid_feats is None or tuple(grid_feats.shape) != (b, n, g):
            raise ValueError(f"film_mlp: grid_feats must be (B, N, {g})")
        # the kernel rounds grid features to bf16 at the first color matmul;
        # rounding here halves the bytes it reads
        gf = grid_feats.to(torch.bfloat16).contiguous()
        _check(gf, "grid_feats", (b, n, g), torch.bfloat16, dev)
    fg, pg, fa, pa = _film_tables(cfg, p.l_geo, p.l_app, film_geo, film_app,
                                  b)
    for name, t, lyrs in (("film_geo", fg, p.l_geo), ("film_app", fa, p.l_app)):
        _check(t, name, (b, lyrs, cfg.hidden_dim), f32, dev)
    _check(pg, "film_geo phases", tuple(fg.shape), f32, dev)
    _check(pa, "film_app phases", tuple(fa.shape), f32, dev)
    for name, t in (("film tables", fg), ("film tables", pg),
                    ("film tables", fa), ("film tables", pa),
                    ("biases", p.biases), ("weights", p.weights)):
        if t.data_ptr() % 16:
            raise ValueError(f"film_mlp: {name} must be 16-byte aligned")
    out = torch.empty(rows, cfg.output_dim, dtype=f32, device=dev)
    if rows == 0:
        return out.reshape(b, n, cfg.output_dim)
    lib = _load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.film_mlp_forward(
        points.data_ptr(), ray_dirs.data_ptr(),
        gf.data_ptr() if gf is not None else None,
        fg.data_ptr(), pg.data_ptr(), fa.data_ptr(), pa.data_ptr(),
        p.weights.data_ptr(), p.biases.data_ptr(), p.program.data_ptr(),
        p.n_layers, rows, n, cfg.hidden_dim, g, p.l_geo, p.l_app,
        p.in_width, p.n_bufs, p.max_n_pad, cfg.output_dim,
        out.data_ptr(), stream)
    if rc != 0:
        msg = lib.film_mlp_error_string(rc).decode()
        raise RuntimeError(f"film_mlp kernel launch failed: {msg} ({rc})")
    film_mlp.launches += 1
    return out.reshape(b, n, cfg.output_dim)


film_mlp.launches = 0
