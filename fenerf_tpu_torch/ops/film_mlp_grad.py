"""Fused FiLM-SIREN field backward: the Python side of the CUDA kernel
(port of the Pallas kernel fenerf_tpu/ops/film_mlp_grad.py::film_mlp_bwd)
and the autograd Function that pairs it with the forward kernel
(the counterpart of make_film_mlp_trainable).

For every point the backward recomputes the forward from the saved inputs,
keeping the pre-sine value y (f32) of each FiLM layer, then runs the chain
rule layer by layer (g = dL/d output of the layer):

    FiLM layer:  s = cos(f*y + p) * g      dfreq += sum s*y, dphase += sum s
                 dy = s * f
    any linear:  dW += bf16(x)^T bf16(dy)  db += sum dy (f32)
                 g_in = bf16(dy) W^T

with the JAX kernel's roundings: bf16 matmul operands, f32 accumulation,
cos as the polynomial sine of v + pi/2, the label head unfolded.

The work is described to the kernel as a PROGRAM of steps (`pack_bwd`),
as the forward kernel's is: each step sums up to three segments of on-chip
buffers times a zero-padded bf16 weight block and ends in one epilogue.
The forward recompute steps use the forward weights; the backward steps
use the transposed weights, so every product is a plain row-tile product.
Inputs of every linear (bf16), its dy (bf16) and every pre-sine y (f32) go
to scratch in device memory; a second kernel forms every dW = x^T dy from
them over row splits, and a third sums the per-split and per-tile partials
in a fixed order (deterministic).

The same program drives the kernel and its plain torch version
`film_mlp_bwd_reference`, so the CPU parity tests against the JAX kernel
check the program the card runs. The plain version keeps its per-row
scratch [row][all layers] (the program's logical slots); the kernel's
scratch is laid out [region][row][width] (`_bwd_plan`'s dev_* offsets): x
and dy in 64-row x 64-column blocks swizzled as the dW kernel's wgmma
operands, y row-major. The weights come in the forward kernel's device
layout (`film_mlp.sw128_index`). The program, the dW work table and the
swizzle index depend only on the configuration and are built once per
(configuration, device); `pack_bwd` pads and scatters the current weights.

Dispatch: `film_mlp_bwd` runs the plain version for CPU tensors and the
CUDA kernels for CUDA tensors (or raises); it never falls back.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Any

import torch

from fenerf_tpu_torch.nn.fields import FieldConfig, init_field
from fenerf_tpu_torch.ops import build
from fenerf_tpu_torch.ops import film_mlp as fwd
from fenerf_tpu_torch.ops.fast_math import fast_sin
from fenerf_tpu_torch.ops.film_mlp import (BUF_A, BUF_B, BUF_IN, IN_DIRS,
                                           IN_GRID, IN_PTS, _pad16,
                                           supported_train)

BUF_S = 3   # small buffer: [sigma dy (16) | label-output dy | rgb dy]
# epilogues
E_FILM_FWD, E_LIN_FWD, E_PRE, E_FILM_BWD, E_LIN_BWD, E_OUT = range(6)
STEP_INTS = 48
HEAD_INTS = 48
TILE = 128          # rows per tile of the row kernel (ops/csrc/film_mlp_bwd.cu)
SPLIT_ROWS = 4096   # rows per split of the dW kernel


def _fcos(v: torch.Tensor) -> torch.Tensor:
    """cos as the polynomial sine of v + pi/2, in f32 (as the JAX kernel)."""
    return fast_sin(v + math.pi / 2.0)


def mlp_layers(params: Any, cfg: FieldConfig) -> list:
    """[(w, b)] in the JAX kernel's order: trunk, color, sigma head, label
    head (unfolded), rgb head."""
    layers = [(l["w"], l["b"]) for l in params["trunk"]]
    layers += [(l["w"], l["b"]) for l in params["color"]]
    layers.append((params["sigma_head"]["w"], params["sigma_head"]["b"]))
    if cfg.n_labels:
        layers += [(l["w"], l["b"]) for l in params["label_head"]]
    layers.append((params["color_head"]["w"], params["color_head"]["b"]))
    return layers


def mlp_params(layers: list, cfg: FieldConfig) -> dict:
    """Inverse of mlp_layers: the params sub-tree of the MLP."""
    lg, lc = cfg.trunk_layers, cfg.color_layers
    lin = lambda wb: {"w": wb[0], "b": wb[1]}
    out = {"trunk": [lin(x) for x in layers[:lg]],
           "color": [lin(x) for x in layers[lg:lg + lc]],
           "sigma_head": lin(layers[lg + lc])}
    i = lg + lc + 1
    if cfg.n_labels:
        n = cfg.label_hidden_layers + 1
        out["label_head"] = [lin(x) for x in layers[i:i + n]]
        i += n
    out["color_head"] = lin(layers[i])
    return out


@dataclasses.dataclass
class _Slots:
    """Column allocator of one per-row scratch array."""
    width: int = 0

    def take(self, n: int, align: int = 16) -> int:
        off = self.width
        self.width += -(-n // align) * align if n else 0
        return off


@dataclasses.dataclass
class BwdPack:
    """Kernel operands of one parameter set: the header and step program
    (int32), the forward and transposed weights (bf16, flat, and in the
    kernel's device layout), the biases (f32, flat), the dW work table,
    and how to unpack padded gradients."""
    cfg: FieldConfig
    program: torch.Tensor      # (HEAD_INTS + STEP_INTS * steps,) int32
    weights: torch.Tensor      # bf16 flat
    biases: torch.Tensor       # f32 flat
    dev_index: torch.Tensor    # gathers `wdev` from `weights` (+ one zero)
    dw_tiles: torch.Tensor     # (items, DW_INTS) int32 (_DW_NAMES)
    head: dict                 # header values by name (_HEAD_NAMES)
    head_host: Any             # the same header as a host int array
    layers: list               # per linear: dict of slots and real shapes
    dw_total: int              # floats of all padded weight gradients

    @functools.cached_property
    def wdev(self) -> torch.Tensor:
        """bf16, the kernel's device layout of `weights`, gathered on
        first use (the plain version never reads it)."""
        w = self.weights
        return torch.cat([w, w.new_zeros(1)])[self.dev_index]


# header fields, in the order of the H_* enum of ops/csrc/film_mlp_bwd.cu;
# the dev_* fields place the kernel's scratch regions (column offsets
# within the x (bf16), dy (bf16) and y (f32) scratch, widths)
_HEAD_NAMES = (
    "n_fwd", "n_bwd", "hidden", "g", "l_geo", "l_app", "in_width",
    "max_n_pad", "y_w", "x_w", "dy_w", "part_w", "phase_off", "xg_pts",
    "xg_dirs", "n_labels", "label_sig", "lbl_y", "lbl_dyg", "lbl_dbp",
    "lbl_col", "rgb_dim", "rgb_sig", "rgb_y", "rgb_dyg", "rgb_dbp", "rgb_col",
    "sig_dyg", "sig_dbp", "small_w", "out_dim", "db_w",
    "dev_x_w", "dev_dy_w", "dev_y_w", "dev_pts_x", "dev_dg_x", "dev_dg_w",
    "dev_lbl_y", "dev_lbl_y_w", "dev_rgb_y", "dev_rgb_y_w", "dev_sig_dy",
    "dev_lbl_dy", "dev_lbl_dy_w", "dev_rgb_dy", "dev_rgb_dy_w", "max_n_dev")
# one dW work item: a 64-column block of one x region of a layer, times
# the layer's dy region, into rows [w_row, w_row + rows) of its padded dW
_DW_NAMES = ("x_co", "x_w", "x_col", "dy_co", "dy_w", "dw_off", "w_row",
             "rows", "n_pad")
DW_INTS = len(_DW_NAMES)
REGION = 64   # columns of one block of the tiled scratch (128 bytes, bf16)


def _pad64(n: int) -> int:
    return -(-n // REGION) * REGION


@dataclasses.dataclass
class _BwdPlan:
    """What a backward pack of one configuration on one device shares with
    every other: the program, the dW table, the header, the recipe of the
    flat weights, the device layout's gather index, and the (in, out) of
    every linear in mlp_layers order that they were built for."""
    program: torch.Tensor
    dw_tiles: torch.Tensor
    head: dict
    head_host: Any
    layers: list
    dw_total: int
    recipe: list               # per step: [(layer, transposed, c0, c1)]
    bias_layers: list          # layers whose padded biases are flattened
    dev_index: torch.Tensor
    shapes: list


@functools.cache
def _bwd_plan(cfg: FieldConfig, device: str) -> _BwdPlan:
    """The backward program of one configuration on one device, built
    from the layer shapes alone (parameters on the meta device)."""
    shapes = [tuple(w.shape) for w, _ in
              mlp_layers(init_field(None, cfg, device="meta"), cfg)]
    h = cfg.hidden_dim
    g = cfg.grid_channels or 0
    gp = _pad16(g) if g else 0
    lg, lc = cfg.trunk_layers, cfg.color_layers
    nl = cfg.n_labels
    lh = cfg.label_hidden_layers if nl else 0
    nlp = _pad16(nl) if nl else 0
    rgbp = _pad16(cfg.rgb_dim)
    i_sig = lg + lc
    i_lbl = i_sig + 1
    i_rgb = i_lbl + (lh + 1 if nl else 0)
    sm_sig, sm_lbl, sm_rgb = 0, 16, 16 + nlp
    small_w = 16 + nlp + rgbp

    # per-layer input segments, real rows each (forward weight row order)
    def in_segs(i):
        if i == 0:
            return [3]
        if i == lg:
            return [3] + ([g] if g else []) + [h]
        return [shapes[i][0]]

    kpad = [sum(_pad16(k) for k in in_segs(i)) for i in range(len(shapes))]
    npad = [_pad16(o) for _, o in shapes]

    # ---- the plain version's per-row scratch slots ------------------------
    ys, xs, dys = _Slots(), _Slots(), _Slots()
    y_t = [ys.take(h) for _ in range(lg)]
    y_c = [ys.take(h) for _ in range(lc)]
    y_lbl = ys.take(nl) if (nl and cfg.label_sigmoid) else -1
    y_rgb = ys.take(cfg.rgb_dim) if cfg.rgb_sigmoid else -1
    xg = [0] * len(shapes)
    xg[0] = xs.take(16)
    for i in range(1, lg):
        xg[i] = xs.take(h)
    xg[lg] = xs.take(16 + gp + h)
    xtrunk = xg[lg] + 16 + gp
    for i in range(lg + 1, lg + lc):
        xg[i] = xs.take(h)
    xg[i_sig] = xtrunk
    if nl:
        xg[i_lbl] = xtrunk
        for j in range(1, lh + 1):
            xg[i_lbl + j] = xs.take(h)
    xg[i_rgb] = xs.take(h)
    dyg = [dys.take(npad[i]) for i in range(len(shapes))]
    dbp, db_w = [], 0
    for n in npad:
        dbp.append(db_w)
        db_w += n
    film_w = 2 * (lg + lc) * h
    part_w = db_w + film_w
    fp = lambda film, chunk: db_w + (chunk if film == 0 else lg + chunk) * h

    # ---- the kernel's scratch regions: [region][row][width] --------------
    # x and dy (bf16) in 64-row x 64-column swizzled blocks (the dW
    # kernel's wgmma operands), y (f32) row-major
    rx, rdy, ry = _Slots(), _Slots(), _Slots()
    hx = _pad64(h)
    x_pts = rx.take(16, REGION)
    x_dg = rx.take(16 + gp, REGION)
    act_t = [rx.take(h, REGION) for _ in range(lg)]
    act_l = [rx.take(h, REGION) for _ in range(lh)]
    act_c = [rx.take(h, REGION) for _ in range(lc)]
    dy_r = [rdy.take(n, REGION) for n in npad]
    dyw = [_pad64(n) for n in npad]
    y_dev_t = [ry.take(h) for _ in range(lg)]
    y_dev_c = [ry.take(h) for _ in range(lc)]
    y_dev_lbl = ry.take(nlp) if (nl and cfg.label_sigmoid) else -1
    y_dev_rgb = ry.take(rgbp) if cfg.rgb_sigmoid else -1
    # x regions of each layer: [(column offset, width, first padded W row,
    # rows)]
    xparts = [[(x_pts, REGION, 0, 16)]]
    xparts += [[(act_t[i - 1], hx, 0, h)] for i in range(1, lg)]
    xparts.append([(x_dg, _pad64(16 + gp), 0, 16 + gp),
                   (act_t[-1], hx, 16 + gp, h)])
    xparts += [[(act_c[i - 1], hx, 0, h)] for i in range(1, lc)]
    xparts.append([(act_t[-1], hx, 0, h)])                    # sigma
    if nl:
        xparts.append([(act_t[-1], hx, 0, h)])
        xparts += [[(act_l[j - 1], hx, 0, h)] for j in range(1, lh + 1)]
    xparts.append([(act_c[-1], hx, 0, h)])                    # rgb

    # ---- steps -------------------------------------------------------
    recipe, bias_layers, steps = [], [], []
    woff, boff, doff = [0], [0], [0]
    # the buffer the kernel holds in registers, and the scratch region
    # that holds each buffer's content: (array 0 x / 1 dy, column, width)
    state = {"reg": None, BUF_A: None, BUF_B: None}

    def add_b(i):
        off = boff[0]
        bias_layers.append(i)
        boff[0] += npad[i]
        return off

    def step(segs, parts, kind, n_valid, b_off=-1, dst=-1, film=0, chunk=0,
             y_off=-1, xg_off=-1, dyg_off=-1, dbp_off=-1, fp_off=-1,
             target=0, y_dev=-1, out_dev=-1, out_w=0):
        k_total = sum(k for _, _, k in segs)
        rows = sum(npad[i] if t else kpad[i] for i, t, _, _ in parts)
        i0, t0, c0, c1 = parts[0]
        n_pad = c1 - c0 if t0 else npad[i0]
        assert rows == k_total, (segs, parts)
        nd = fwd.n_dev(n_pad)
        kch = -(-k_total // fwd.KCHUNK)
        chunks = kch * (nd // min(nd, fwd.PASS))
        d = [0] * STEP_INTS
        d[0] = len(segs)
        for s, (src, col, k) in enumerate(segs):
            d[1 + 3 * s:4 + 3 * s] = [src, col, k]
            co, w, arr = -1, 0, 0
            if src in (BUF_A, BUF_B) and src != state["reg"]:
                arr, co, w = state[src]
            d[33 + s], d[36 + s], d[39 + s] = co, w, arr
        d[10:33] = [n_pad, woff[0], b_off, kind, dst, 0, film, chunk,
                    n_valid, y_off, xg_off, dyg_off, dbp_off, fp_off, target,
                    k_total, nd, doff[0], chunks, y_dev, n_pad, out_dev,
                    out_w]
        recipe.append(parts)
        steps.append(d)
        woff[0] += k_total * n_pad
        doff[0] += kch * nd * fwd.KCHUNK
        if dst in (BUF_A, BUF_B):
            state["reg"] = dst
            state[dst] = (int(kind >= E_FILM_BWD), out_dev, out_w)

    whole = lambda i: [(i, False, 0, npad[i])]
    tr = lambda i, c0=0, c1=None: (i, True, c0, kpad[i] if c1 is None else c1)

    # forward recompute
    for i in range(lg):
        segs = [(BUF_IN, IN_PTS, 16)] if i == 0 else [(BUF_A, 0, h)]
        step(segs, whole(i), E_FILM_FWD, h, b_off=add_b(i), dst=BUF_A,
             film=0, chunk=i, y_off=y_t[i],
             xg_off=xg[i + 1] if i + 1 < lg else xtrunk, y_dev=y_dev_t[i],
             out_dev=act_t[i], out_w=hx)
    src = BUF_A
    for j in range(lh):
        i = i_lbl + j
        step([(src, 0, h)], whole(i), E_LIN_FWD, h, b_off=add_b(i),
             dst=BUF_B, xg_off=xg[i + 1], out_dev=act_l[j], out_w=hx)
        src = BUF_B
    if nl and cfg.label_sigmoid:
        i = i_lbl + lh
        step([(src, 0, h)], whole(i), E_PRE, nl, b_off=add_b(i), y_off=y_lbl,
             y_dev=y_dev_lbl)
    for i in range(lc):
        li = lg + i
        if i == 0:
            segs = [(BUF_IN, IN_DIRS, 16)] + (
                [(BUF_IN, IN_GRID, gp)] if g else []) + [(BUF_A, 0, h)]
        else:
            segs = [(BUF_B, 0, h)]
        step(segs, whole(li), E_FILM_FWD, h, b_off=add_b(li), dst=BUF_B,
             film=1, chunk=i, y_off=y_c[i],
             xg_off=xg[li + 1] if i + 1 < lc else xg[i_rgb],
             y_dev=y_dev_c[i], out_dev=act_c[i], out_w=hx)
    if cfg.rgb_sigmoid:
        step([(BUF_B, 0, h)], whole(i_rgb), E_PRE, cfg.rgb_dim,
             b_off=add_b(i_rgb), y_off=y_rgb, y_dev=y_dev_rgb)
    n_fwd = len(steps)

    # backward: label chain, rgb -> color chain, color0 -> dirs / grid,
    # [label | sigma | color0] -> trunk chain, trunk0 -> points
    state["reg"] = None
    for j in range(lh, 0, -1):
        i = i_lbl + j
        src = (BUF_S, sm_lbl, nlp) if j == lh else (BUF_A, 0, h)
        step([src], [tr(i)], E_LIN_BWD, h, dst=BUF_A, dyg_off=dyg[i - 1],
             dbp_off=dbp[i - 1], out_dev=dy_r[i - 1], out_w=dyw[i - 1])
    step([(BUF_S, sm_rgb, rgbp)], [tr(i_rgb)], E_FILM_BWD, h, dst=BUF_B,
         film=1, chunk=lc - 1, y_off=y_c[lc - 1], dyg_off=dyg[lg + lc - 1],
         dbp_off=dbp[lg + lc - 1], fp_off=fp(1, lc - 1),
         y_dev=y_dev_c[lc - 1], out_dev=dy_r[lg + lc - 1],
         out_w=dyw[lg + lc - 1])
    for i in range(lc - 1, 0, -1):
        step([(BUF_B, 0, h)], [tr(lg + i)], E_FILM_BWD, h, dst=BUF_B, film=1,
             chunk=i - 1, y_off=y_c[i - 1], dyg_off=dyg[lg + i - 1],
             dbp_off=dbp[lg + i - 1], fp_off=fp(1, i - 1),
             y_dev=y_dev_c[i - 1], out_dev=dy_r[lg + i - 1],
             out_w=dyw[lg + i - 1])
    step([(BUF_B, 0, h)], [tr(lg, 0, 16 + gp)], E_OUT, 16 + gp, target=1)
    segs, parts = [], []
    if nl:
        segs.append((BUF_A, 0, h) if lh else (BUF_S, sm_lbl, nlp))
        parts.append(tr(i_lbl))
    segs.append((BUF_S, sm_sig, 16))
    parts.append(tr(i_sig))
    segs.append((BUF_B, 0, h))
    parts.append(tr(lg, 16 + gp))
    step(segs, parts, E_FILM_BWD, h, dst=BUF_A, film=0, chunk=lg - 1,
         y_off=y_t[lg - 1], dyg_off=dyg[lg - 1], dbp_off=dbp[lg - 1],
         fp_off=fp(0, lg - 1), y_dev=y_dev_t[lg - 1], out_dev=dy_r[lg - 1],
         out_w=dyw[lg - 1])
    for i in range(lg - 1, 0, -1):
        step([(BUF_A, 0, h)], [tr(i)], E_FILM_BWD, h, dst=BUF_A, film=0,
             chunk=i - 1, y_off=y_t[i - 1], dyg_off=dyg[i - 1],
             dbp_off=dbp[i - 1], fp_off=fp(0, i - 1), y_dev=y_dev_t[i - 1],
             out_dev=dy_r[i - 1], out_w=dyw[i - 1])
    step([(BUF_A, 0, h)], [tr(0)], E_OUT, 16, target=0)
    n_bwd = len(steps) - n_fwd

    # ---- dW work items and unpacking ----------------------------------
    lay, tiles, dw_total = [], [], 0
    for i, (k_in, n_out) in enumerate(shapes):
        rows = []
        rp = 0
        for k in in_segs(i):
            rows += range(rp, rp + k)
            rp += _pad16(k)
        lay.append(dict(dw=dw_total, k=kpad[i], n=npad[i], rows=rows,
                        rows_t=torch.tensor(rows, device=device),
                        n_real=n_out, db=dbp[i], xg=xg[i], dyg=dyg[i]))
        for co, w, w_row, n_rows in xparts[i]:
            for c0 in range(0, n_rows, REGION):
                tiles.append([co, w, c0, dy_r[i], dyw[i], dw_total,
                              w_row + c0, min(REGION, n_rows - c0), npad[i]])
        dw_total += kpad[i] * npad[i]

    head = dict(
        n_fwd=n_fwd, n_bwd=n_bwd, hidden=h, g=g, l_geo=lg, l_app=lc,
        in_width=IN_GRID + gp, max_n_pad=max(d[10] for d in steps),
        y_w=max(ys.width, 16), x_w=xs.width, dy_w=dys.width, part_w=part_w,
        phase_off=(lg + lc) * h, xg_pts=xg[0], xg_dirs=xg[lg], n_labels=nl,
        label_sig=int(bool(nl and cfg.label_sigmoid)), lbl_y=y_lbl,
        lbl_dyg=dyg[i_lbl + lh] if nl else -1,
        lbl_dbp=dbp[i_lbl + lh] if nl else -1, lbl_col=sm_lbl,
        rgb_dim=cfg.rgb_dim, rgb_sig=int(cfg.rgb_sigmoid), rgb_y=y_rgb,
        rgb_dyg=dyg[i_rgb], rgb_dbp=dbp[i_rgb], rgb_col=sm_rgb,
        sig_dyg=dyg[i_sig], sig_dbp=dbp[i_sig], small_w=small_w,
        out_dim=cfg.output_dim, db_w=db_w,
        dev_x_w=rx.width, dev_dy_w=rdy.width, dev_y_w=max(ry.width, 16),
        dev_pts_x=x_pts, dev_dg_x=x_dg, dev_dg_w=_pad64(16 + gp),
        dev_lbl_y=y_dev_lbl, dev_lbl_y_w=nlp,
        dev_rgb_y=y_dev_rgb, dev_rgb_y_w=rgbp, dev_sig_dy=dy_r[i_sig],
        dev_lbl_dy=dy_r[i_lbl + lh] if nl else -1,
        dev_lbl_dy_w=dyw[i_lbl + lh] if nl else 0,
        dev_rgb_dy=dy_r[i_rgb], dev_rgb_dy_w=dyw[i_rgb],
        max_n_dev=max(d[26] for d in steps))
    assert len(_HEAD_NAMES) <= HEAD_INTS
    hdr = [head[k] for k in _HEAD_NAMES] + [0] * (HEAD_INTS - len(_HEAD_NAMES))
    prog = hdr + [x for d in steps for x in d]
    zero = woff[0]
    dev_index = torch.cat([fwd.sw128_index(d[25], d[10], d[26], d[11], zero)
                           for d in steps])
    return _BwdPlan(
        program=torch.tensor(prog, dtype=torch.int32, device=device),
        dw_tiles=torch.tensor(tiles, dtype=torch.int32, device=device),
        head=head, head_host=(ctypes.c_int * HEAD_INTS)(*hdr), layers=lay,
        dw_total=dw_total, recipe=recipe, bias_layers=bias_layers,
        dev_index=dev_index.to(device), shapes=shapes)


def pack_bwd(params: Any, cfg: FieldConfig) -> BwdPack:
    """The backward operands of the CURRENT parameters (build them on every
    call: a pack kept across optimizer steps would be stale). The program
    is built once per configuration and device; a call pads, transposes and
    scatters the weights."""
    if not supported_train(cfg):
        raise ValueError(f"variant {cfg.name} is not covered by film_mlp_bwd")
    device = params["trunk"][0]["w"].device
    layers = mlp_layers(params, cfg)
    plan = _bwd_plan(cfg, str(device))
    if [tuple(w.shape) for w, _ in layers] != plan.shapes:
        raise ValueError(f"parameters do not have the shapes of {cfg.name}")
    h, g = cfg.hidden_dim, cfg.grid_channels or 0
    lg = cfg.trunk_layers
    f32 = lambda t: t.detach().to(torch.float32)

    # forward weights, zero-padded, rows in segment order (as film_mlp.pack)
    wpad = []
    for i, (w, b) in enumerate(layers):
        lay = plan.layers[i]
        wp = torch.zeros(lay["k"], lay["n"], dtype=torch.float32,
                         device=device)
        if i == lg:   # [ray_dir(3) | grid(G) | x(H)] rows into 16-row pads
            gp = _pad16(g) if g else 0
            wp[0:3, :w.shape[1]] = f32(w)[0:3]
            if g:
                wp[16:16 + g, :w.shape[1]] = f32(w)[3:3 + g]
            wp[16 + gp:16 + gp + h, :w.shape[1]] = f32(w)[3 + g:]
        else:
            wp[:w.shape[0], :w.shape[1]] = f32(w)
        wpad.append(wp)
    blocks = []
    for parts in plan.recipe:
        m = torch.cat([wpad[i].t()[:, c0:c1] if t else wpad[i]
                       for i, t, c0, c1 in parts], dim=0)
        blocks.append(m.to(torch.bfloat16).reshape(-1))
    biases = []
    for i in plan.bias_layers:
        bp = torch.zeros(plan.layers[i]["n"], dtype=torch.float32,
                         device=device)
        bp[:layers[i][1].shape[0]] = f32(layers[i][1])
        biases.append(bp)
    return BwdPack(
        cfg=cfg, program=plan.program, weights=torch.cat(blocks),
        biases=torch.cat(biases), dev_index=plan.dev_index,
        dw_tiles=plan.dw_tiles,
        head=plan.head, head_host=plan.head_host, layers=plan.layers,
        dw_total=plan.dw_total)


def _film_tables(cfg: FieldConfig, film_geo, film_app, b: int):
    return fwd._film_tables(cfg, cfg.trunk_layers, cfg.color_layers,
                            film_geo, film_app, b)


def _unpack(p: BwdPack, dw_flat, db_flat, film, b: int):
    """Padded kernel gradients -> [(dW, db)] per layer in mlp_layers order
    and (dfg, dpg, dfa, dpa) as (B, L*H), freq grads times freq_scale."""
    cfg = p.cfg
    h, lg, lc = cfg.hidden_dim, cfg.trunk_layers, cfg.color_layers
    out = []
    for lay in p.layers:
        dw = dw_flat[lay["dw"]:lay["dw"] + lay["k"] * lay["n"]].reshape(
            lay["k"], lay["n"])
        rows = lay["rows_t"]
        out.append((dw.index_select(0, rows)[:, :lay["n_real"]].contiguous(),
                    db_flat[lay["db"]:lay["db"] + lay["n_real"]].clone()))
    film = film.reshape(b, 2, lg + lc, h)
    dfreq, dphase = film[:, 0] * cfg.freq_scale, film[:, 1]
    return (out, dfreq[:, :lg].reshape(b, lg * h).contiguous(),
            dphase[:, :lg].reshape(b, lg * h).contiguous(),
            dfreq[:, lg:].reshape(b, lc * h).contiguous(),
            dphase[:, lg:].reshape(b, lc * h).contiguous())


def film_mlp_bwd_reference(p: BwdPack, points, ray_dirs, grid_feats,
                           film_geo, film_app, g_out):
    """The plain torch version of the kernels: the same program, padded
    weights and roundings, step by step. Matmul operands are bf16 values
    held in f32. Returns ([(dW, db)] per layer, dpoints, ddirs, dgf,
    dfg, dpg, dfa, dpa)."""
    film_mlp_bwd_reference.calls += 1
    cfg, hd = p.cfg, p.head
    b, n, _ = points.shape
    rows = b * n
    h, g = cfg.hidden_dim, hd["g"]
    dev = points.device
    bf = lambda t: t.to(torch.bfloat16).to(torch.float32)
    ftab = _film_tables(cfg, film_geo, film_app, b)
    inb = points.new_zeros(rows, hd["in_width"])
    inb[:, IN_PTS:IN_PTS + 3] = points.detach().reshape(rows, 3)
    inb[:, IN_DIRS:IN_DIRS + 3] = ray_dirs.detach().reshape(rows, 3)
    if g:
        inb[:, IN_GRID:IN_GRID + g] = grid_feats.detach().reshape(
            rows, g).float()
    inb = bf(inb)
    z = lambda w: torch.zeros(rows, w, dtype=torch.float32, device=dev)
    bufs = {BUF_IN: inb, BUF_A: z(h), BUF_B: z(h), BUF_S: z(hd["small_w"])}
    Y, X, DY = z(hd["y_w"]), z(hd["x_w"]), z(hd["dy_w"])
    X[:, hd["xg_pts"]:hd["xg_pts"] + 16] = inb[:, 0:16]
    X[:, hd["xg_dirs"]:hd["xg_dirs"] + hd["in_width"] - IN_DIRS] = \
        inb[:, IN_DIRS:]
    db_w = hd["db_w"]
    db = torch.zeros(db_w, dtype=torch.float32, device=dev)
    film = torch.zeros(b, hd["part_w"] - db_w, dtype=torch.float32,
                       device=dev)
    per_b = lambda t: t.reshape(b, n, -1).sum(1)
    dpts = ddirs = dgf = None
    go = g_out.detach().to(torch.float32).reshape(rows, -1)
    prog = p.program.tolist()
    steps = [prog[HEAD_INTS + i * STEP_INTS:HEAD_INTS + (i + 1) * STEP_INTS]
             for i in range(hd["n_fwd"] + hd["n_bwd"])]

    def seed():
        nl, od = hd["n_labels"], hd["out_dim"]
        heads = [(od - 1, 1, 0, -1, hd["sig_dyg"], hd["sig_dbp"], 0)]
        if nl:
            heads.append((0, nl, hd["label_sig"], hd["lbl_y"], hd["lbl_dyg"],
                          hd["lbl_dbp"], hd["lbl_col"]))
        heads.append((nl, hd["rgb_dim"], hd["rgb_sig"], hd["rgb_y"],
                      hd["rgb_dyg"], hd["rgb_dbp"], hd["rgb_col"]))
        for col, w, sig, y_off, dyg_off, dbp_off, sm_col in heads:
            dy = go[:, col:col + w]
            if sig:
                sv = torch.sigmoid(Y[:, y_off:y_off + w])
                dy = dy * sv * (1 - sv)
            bufs[BUF_S][:, sm_col:sm_col + w] = bf(dy)
            DY[:, dyg_off:dyg_off + w] = bf(dy)
            db[dbp_off:dbp_off + w] += dy.sum(0)

    for si, d in enumerate(steps):
        if si == hd["n_fwd"]:
            seed()
        n_pad, w_off, b_off, kind, dst, _, fi, chunk, n_valid, y_off, \
            xg_off, dyg_off, dbp_off, fp_off, target, k_total = d[10:26]
        x = torch.cat([bufs[d[1 + 3 * s]][:, d[2 + 3 * s]:
                                          d[2 + 3 * s] + d[3 + 3 * s]]
                       for s in range(d[0])], dim=1)
        w = p.weights[w_off:w_off + k_total * n_pad].reshape(k_total, n_pad)
        acc = x @ w.float()
        if kind in (E_FILM_FWD, E_FILM_BWD):
            f = ftab[0 if fi == 0 else 2][:, chunk][:, None, :]
            ph = ftab[1 if fi == 0 else 3][:, chunk][:, None, :]
        if kind in (E_FILM_FWD, E_LIN_FWD, E_PRE):
            v = acc + p.biases[b_off:b_off + n_pad]
            if kind == E_PRE:
                Y[:, y_off:y_off + n_pad] = v
                continue
            if kind == E_FILM_FWD:
                Y[:, y_off:y_off + n_pad] = v
                v = fast_sin(f * v.reshape(b, n, n_pad) + ph).reshape(
                    rows, n_pad)
            bufs[dst] = bf(v)
            X[:, xg_off:xg_off + n_pad] = bf(v)
        elif kind in (E_FILM_BWD, E_LIN_BWD):
            dy = acc
            if kind == E_FILM_BWD:
                y = Y[:, y_off:y_off + n_pad].reshape(b, n, n_pad)
                s = (_fcos(f * y + ph) * acc.reshape(b, n, n_pad))
                film[:, fp_off - db_w:fp_off - db_w + n_pad] += \
                    (s * y).sum(1)
                po = fp_off - db_w + hd["phase_off"]
                film[:, po:po + n_pad] += s.sum(1)
                dy = (s * f).reshape(rows, n_pad)
            bufs[dst] = bf(dy)
            DY[:, dyg_off:dyg_off + n_pad] = bf(dy)
            db[dbp_off:dbp_off + n_pad] += dy.sum(0)
        else:  # E_OUT
            if target == 0:
                dpts = acc[:, 0:3].reshape(b, n, 3)
            else:
                ddirs = acc[:, 0:3].reshape(b, n, 3)
                if g:
                    dgf = acc[:, 16:16 + g].reshape(b, n, g)
    dw = torch.cat([(X[:, lay["xg"]:lay["xg"] + lay["k"]].t()
                     @ DY[:, lay["dyg"]:lay["dyg"] + lay["n"]]).reshape(-1)
                    for lay in p.layers])
    layers, dfg, dpg, dfa, dpa = _unpack(p, dw, db, film, b)
    return layers, dpts, ddirs, dgf, dfg, dpg, dfa, dpa


film_mlp_bwd_reference.calls = 0

# The kernels against their plain version, per output group. Both round
# every product operand to bf16 and accumulate in f32; they differ in
# summation order only, which moves a bf16 rounding of an intermediate dy
# here and there: max|kernel - plain| / max|plain| and the cosine.
BWD_TOL, BWD_COS = 2e-2, 0.999
# dpoints / ddirs / dgf: each element is one short sum of bf16-rounded terms
# that cancel, so one rounding flip moves an element by a larger share of
# the group's largest value (up to 2.3e-2 read on an H100 at a few hundred
# rows per batch element)
BWD_TOL_PER_POINT = 5e-2
PER_POINT = ("dpoints", "ddirs", "dgf")
OUTPUT_GROUPS = PER_POINT + ("dfg", "dpg", "dfa", "dpa")


def bwd_agreement(out, ref) -> list:
    """film_mlp_bwd's output against its plain version's on the same
    inputs: [(group, max|out - ref| / max|ref|, cosine, within limits)] for
    every dW, db and output group. A group that is zero on both sides
    reads 0 and 1; a non-finite one is never within limits."""
    pairs = [(f"dW[{i}]", a[0], b[0]) for i, (a, b) in
             enumerate(zip(out[0], ref[0]))]
    pairs += [(f"db[{i}]", a[1], b[1]) for i, (a, b) in
              enumerate(zip(out[0], ref[0]))]
    pairs += [(nm, a, b) for nm, a, b in zip(OUTPUT_GROUPS, out[1:], ref[1:])
              if b is not None]
    rows = []
    for nm, a, b in pairs:
        a, b = a.double().flatten(), b.double().flatten()
        scale = b.abs().max().item()
        if scale < 1e-8 and a.abs().max().item() < 1e-8:
            rel, cos = 0.0, 1.0
        else:
            rel = (a - b).abs().max().item() / max(scale, 1e-30)
            cos = (a @ b).item() / max(a.norm().item() * b.norm().item(),
                                       1e-30)
        tol = BWD_TOL_PER_POINT if nm in PER_POINT else BWD_TOL
        rows.append((nm, rel, cos, rel <= tol and cos > BWD_COS))
    return rows


# ---------------------------------------------------------------------------
# The CUDA kernels: built with nvcc at first use (ops/build.py), bound with
# ctypes
# ---------------------------------------------------------------------------

_LIB = None


def _load_library():
    """ops/csrc/film_mlp_bwd.cu, built for sm_90a into build/ and loaded."""
    global _LIB
    if _LIB is None:
        lib = build.library("film_mlp_bwd")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.film_mlp_bwd_launch.argtypes = (
            [vp] * 11 + [ci] * 5 + [vp] * 8 + [ci] * 3 + [vp] * 6)
        lib.film_mlp_bwd_launch.restype = ci
        lib.film_mlp_bwd_error_string.argtypes = [ci]
        lib.film_mlp_bwd_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(t, name, shape, dtype, device):
    fwd._check(t, name, shape, dtype, device, who="film_mlp_bwd")


def film_mlp_bwd(p: BwdPack, points, ray_dirs, grid_feats, film_geo,
                 film_app, g_out):
    """Fused field backward. CPU tensors take film_mlp_bwd_reference; CUDA
    tensors launch the sm_90a kernels (ops/csrc/film_mlp_bwd.cu) or raise.
    Returns ([(dW, db)] per layer in mlp_layers order, dpoints, ddirs, dgf,
    dfg, dpg, dfa, dpa)."""
    if points.device.type == "cpu":
        return film_mlp_bwd_reference(p, points, ray_dirs, grid_feats,
                                      film_geo, film_app, g_out)
    if points.device.type != "cuda":
        raise ValueError(f"film_mlp_bwd: no kernel for device {points.device}")
    cfg, hd = p.cfg, p.head
    dev = points.device
    b, n, _ = points.shape
    g = hd["g"]
    f32 = torch.float32
    _check(points, "points", (b, n, 3), f32, dev)
    _check(ray_dirs, "ray_dirs", (b, n, 3), f32, dev)
    _check(g_out, "g_out", (b, n, cfg.output_dim), f32, dev)
    for name, t in (("program", p.program), ("weights", p.wdev),
                    ("biases", p.biases), ("dw_tiles", p.dw_tiles)):
        if t.device != dev:
            raise ValueError(f"film_mlp_bwd: pack {name} on {t.device}, "
                             f"points on {dev}")
    gf = None
    if g:
        if grid_feats is None or tuple(grid_feats.shape) != (b, n, g):
            raise ValueError(f"film_mlp_bwd: grid_feats must be (B, N, {g})")
        # the kernel rounds grid features to bf16 at the first color product
        gf = grid_feats.detach().to(torch.bfloat16).contiguous()
        _check(gf, "grid_feats", (b, n, g), torch.bfloat16, dev)
    fg, pg, fa, pa = _film_tables(cfg, film_geo, film_app, b)
    h = cfg.hidden_dim
    for name, t, lyrs in (("film_geo", fg, cfg.trunk_layers),
                          ("film_geo phases", pg, cfg.trunk_layers),
                          ("film_app", fa, cfg.color_layers),
                          ("film_app phases", pa, cfg.color_layers)):
        _check(t, name, (b, lyrs, h), f32, dev)
    tpb = -(-n // TILE)
    n_tiles = b * tpb
    rs = n_tiles * TILE
    n_splits = -(-rs // SPLIT_ROWS)
    part_w = hd["part_w"]
    e = lambda *shape, dt=f32: torch.empty(*shape, dtype=dt, device=dev)
    # scratch regions [region][row][width] (ops/film_mlp_grad.py::_bwd_plan)
    y_scr = e(rs * hd["dev_y_w"])
    x_scr = e(rs * hd["dev_x_w"], dt=torch.bfloat16)
    dy_scr = e(rs * hd["dev_dy_w"], dt=torch.bfloat16)
    tile_part = e(2 * n_tiles, part_w)   # per (tile, warpgroup)
    dw_part = e(n_splits, p.dw_total)
    dw = e(p.dw_total)
    film_w = part_w - hd["db_w"]
    db = e(hd["db_w"])
    film = e(b, film_w)
    dpts, ddirs = e(b, n, 3), e(b, n, 3)
    dgf = e(b, n, g) if g else None
    for name, t in (("film tables", fg), ("film tables", pg),
                    ("film tables", fa), ("film tables", pa),
                    ("biases", p.biases), ("weights", p.wdev)):
        if t.data_ptr() % 16:
            raise ValueError(f"film_mlp_bwd: {name} must be 16-byte aligned")
    lib = _load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = lib.film_mlp_bwd_launch(
        ptr(points), ptr(ray_dirs), ptr(gf), ptr(g_out), ptr(fg), ptr(pg),
        ptr(fa), ptr(pa), ptr(p.wdev), ptr(p.biases), ptr(p.program),
        p.biases.numel(), b, n, p.dw_tiles.shape[0], n_splits,
        ptr(p.dw_tiles), ptr(y_scr), ptr(x_scr), ptr(dy_scr),
        ptr(tile_part), ptr(dw_part), ptr(dw), ptr(db),
        p.dw_total, SPLIT_ROWS, film_w,
        ptr(film), ptr(dpts), ptr(ddirs), ptr(dgf), p.head_host, stream)
    if rc != 0:
        msg = lib.film_mlp_bwd_error_string(rc).decode()
        raise RuntimeError(f"film_mlp_bwd kernel launch failed: {msg} ({rc})")
    film_mlp_bwd.launches += 1
    layers, dfg, dpg, dfa, dpa = _unpack(p, dw, db, film, b)
    return layers, dpts, ddirs, dgf, dfg, dpg, dfa, dpa


film_mlp_bwd.launches = 0


# ---------------------------------------------------------------------------
# autograd: forward kernel + backward kernel
# ---------------------------------------------------------------------------

class FilmMlpTrainable(torch.autograd.Function):
    """The field MLP with the fused forward (film_mlp) and backward
    (film_mlp_bwd): the counterpart of the JAX package's custom VJP. Inputs
    are the raw layer tensors, so gradients reach the parameters
    themselves; only the inputs are saved, the backward recomputes the
    activations. Both kernels' operands are packed from the current
    parameters on every call."""

    @staticmethod
    def forward(ctx, cfg, points, dirs, gf, fg, pg, fa, pa, *leaves):
        layers = [(leaves[2 * i], leaves[2 * i + 1])
                  for i in range(len(leaves) // 2)]
        params = mlp_params(layers, cfg)
        pack = fwd.pack(params, cfg)
        out = fwd.film_mlp(pack, points, dirs, gf, (fg, pg), (fa, pa))
        ctx.cfg = cfg
        ctx.save_for_backward(points, dirs, gf, fg, pg, fa, pa, *leaves)
        return out

    @staticmethod
    def backward(ctx, g_out):
        points, dirs, gf, fg, pg, fa, pa, *leaves = ctx.saved_tensors
        cfg = ctx.cfg
        layers = [(leaves[2 * i], leaves[2 * i + 1])
                  for i in range(len(leaves) // 2)]
        pack = pack_bwd(mlp_params(layers, cfg), cfg)
        dlayers, dpts, ddirs, dgf, dfg, dpg, dfa, dpa = film_mlp_bwd(
            pack, points, dirs, gf, (fg, pg), (fa, pa),
            g_out.to(torch.float32).contiguous())
        if dgf is not None:
            dgf = dgf.to(gf.dtype)
        dleaves = [t for wb in dlayers for t in wb]
        return (None, dpts, ddirs, dgf, dfg, dpg, dfa, dpa, *dleaves)


def film_mlp_trainable(params: Any, cfg: FieldConfig, points, dirs, gf,
                       film_geo, film_app):
    """(B, N, 3) box-warped points -> (B, N, output_dim), differentiable
    w.r.t. the MLP parameters, points, dirs, grid features and film."""
    leaves = [t for wb in mlp_layers(params, cfg) for t in wb]
    return FilmMlpTrainable.apply(cfg, points, dirs, gf, film_geo[0],
                                  film_geo[1], film_app[0], film_app[1],
                                  *leaves)
