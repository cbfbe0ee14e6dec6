"""Trilinear 3D texture-grid sampling (port of fenerf_tpu/core/grid_sample.py:
grid_sample_3d, the z-expanded table with its hand adjoint, and the table
sampler).

Semantics of torch.nn.functional.grid_sample(mode='bilinear',
padding_mode='zeros', align_corners=True) on a (C, D, H, W) grid with
normalized coords (x, y, z) indexing (W, H, D).

The serving path samples through the z-expanded table: row (z, y, x) holds
the whole zero-padded 2x2x2 neighbourhood, channels minor, so one row
gather plus an 8-term weighted sum gives the trilinear value. The flagship
table is (97^3, 8*32) in bf16, 467 MB: build it once per loaded checkpoint
or once per render (fields.with_grid_table), never once per ray block.
"""
from __future__ import annotations

import torch


def grid_sample_3d(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample `grid` (C, D, H, W) at `coords` (..., 3) in [-1, 1] with
    8 corner gathers. Returns (..., C)."""
    c, d, h, w = grid.shape
    batch_shape = coords.shape[:-1]
    xyz = coords.reshape(-1, 3)
    sizes = torch.tensor([w, h, d], dtype=coords.dtype, device=coords.device)
    idx = (xyz + 1.0) / 2.0 * (sizes - 1.0)
    i0f = torch.floor(idx)
    frac = idx - i0f
    i0 = i0f.to(torch.int64)
    i1 = i0 + 1
    dims = (w, h, d)
    valid0 = [(i0[:, a] >= 0) & (i0[:, a] < s) for a, s in enumerate(dims)]
    valid1 = [(i1[:, a] >= 0) & (i1[:, a] < s) for a, s in enumerate(dims)]
    c0 = [i0[:, a].clamp(0, s - 1) for a, s in enumerate(dims)]
    c1 = [i1[:, a].clamp(0, s - 1) for a, s in enumerate(dims)]
    flat = grid.reshape(c, -1).T  # (D*H*W, C)

    out = 0.0
    for bz, (zi, zv) in enumerate(((c0[2], valid0[2]), (c1[2], valid1[2]))):
        wz = (1.0 - frac[:, 2]) if bz == 0 else frac[:, 2]
        for by, (yi, yv) in enumerate(((c0[1], valid0[1]),
                                       (c1[1], valid1[1]))):
            wy = (1.0 - frac[:, 1]) if by == 0 else frac[:, 1]
            for bx, (xi, xv) in enumerate(((c0[0], valid0[0]),
                                           (c1[0], valid1[0]))):
                wx = (1.0 - frac[:, 0]) if bx == 0 else frac[:, 0]
                vals = flat[(zi * h + yi) * w + xi]
                weight = wz * wy * wx * (zv & yv & xv).to(coords.dtype)
                out = out + vals * weight[:, None]
    return out.reshape(*batch_shape, c)


def _build_zexp_rows(grid: torch.Tensor, table_dtype=None) -> torch.Tensor:
    c, d, h, w = grid.shape
    p = torch.nn.functional.pad(grid, (1, 1, 1, 1, 1, 1))
    if table_dtype is not None:
        p = p.to(table_dtype)
    pt = p.permute(1, 2, 3, 0)  # (D+2, H+2, W+2, C), channels minor
    table = torch.cat(
        [pt[dz:dz + d + 1, dy:dy + h + 1, dx:dx + w + 1]
         for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)],
        dim=-1)
    return table.reshape((d + 1) * (h + 1) * (w + 1), 8 * c)


def zexp_table_adjoint(dtable: torch.Tensor, grid_shape,
                       out_dtype=torch.float32) -> torch.Tensor:
    """Exact adjoint of the (linear) table build: a table cotangent
    ((D+1)(H+1)(W+1), 8C) -> the grid cotangent (C, D, H, W):
    dgrid[c, z, y, x] = sum_k dtable[(z+1-dz, y+1-dy, x+1-dx), k*C + c],
    summed in f32 whatever the table's dtype.

    A CPU tensor takes the slice fold (zexp_table_adjoint_torch); any other
    goes to the fold kernel (ops/zexp_fold.py::fold_zexp), which the card
    holds bit-exact to the slice fold. Unlike the JAX package, whose kernel
    is behind a switch and which warns and falls back to its slice fold for
    a non-f32 out_dtype, the port does not fall back: a non-f32 out_dtype
    off the CPU raises ValueError."""
    if dtable.device.type == "cpu":
        return zexp_table_adjoint_torch(dtable, grid_shape, out_dtype)
    if out_dtype != torch.float32:
        raise ValueError(f"zexp_table_adjoint on {dtable.device}: the fold "
                         f"kernel writes float32, not {out_dtype}")
    from fenerf_tpu_torch.ops.zexp_fold import fold_zexp

    return fold_zexp(dtable, grid_shape)


def zexp_table_adjoint_torch(dtable: torch.Tensor, grid_shape,
                             out_dtype=torch.float32) -> torch.Tensor:
    """The fold as 8 shifted slices summed in f32 in the order k = 0..7
    (the torch route, and the fold kernel's plain version)."""
    c, d, h, w = grid_shape
    dt = dtable.reshape(d + 1, h + 1, w + 1, 8 * c)
    out = None
    for k, (dz, dy, dx) in enumerate(
            (dz, dy, dx) for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)):
        t = dt[1 - dz:1 - dz + d, 1 - dy:1 - dy + h, 1 - dx:1 - dx + w,
               k * c:(k + 1) * c].to(torch.float32)
        out = t if out is None else out + t
    return out.permute(3, 0, 1, 2).to(out_dtype).contiguous()


class _BuildZexp(torch.autograd.Function):
    """The table build with the hand adjoint as its backward (autograd's
    own transpose would scatter through the 8x-expanded cotangent)."""

    @staticmethod
    def forward(ctx, grid, table_dtype):
        ctx.grid_shape = tuple(grid.shape)
        ctx.grid_dtype = grid.dtype
        return _build_zexp_rows(grid, table_dtype)

    @staticmethod
    def backward(ctx, dtable):
        return (zexp_table_adjoint(dtable, ctx.grid_shape, ctx.grid_dtype),
                None)


def build_zexp_table(grid: torch.Tensor, table_dtype=None) -> torch.Tensor:
    """The z-expanded gather table of `grid` (C, D, H, W):
    ((D+1)(H+1)(W+1), 8C), row (z, y, x), column k*C + c holds
    P[c, z+dz, y+dy, x+dx] of the zero-padded grid P, k = dz*4 + dy*2 + dx.
    Differentiable w.r.t. grid through zexp_table_adjoint."""
    return _BuildZexp.apply(grid, table_dtype)


def sample_zexp_table(table: torch.Tensor, grid_shape,
                      coords: torch.Tensor) -> torch.Tensor:
    """Trilinear sample from a prebuilt table: one row gather and an
    8-term weighted reduce, accumulated in the coords' dtype. Same
    semantics as grid_sample_3d."""
    c, d, h, w = grid_shape
    hp, wp = h + 1, w + 1
    batch_shape = coords.shape[:-1]
    xyz = coords.reshape(-1, 3)
    dt = coords.dtype
    sizes = torch.tensor([w, h, d], dtype=dt, device=coords.device)
    idx = (xyz + 1.0) / 2.0 * (sizes - 1.0)
    i0f = torch.floor(idx)
    fx, fy, fz = (idx - i0f).unbind(-1)
    x0, y0, z0 = i0f.to(torch.int64).unbind(-1)

    # valid where clamping does not move the base corner; points with both
    # neighbours outside the grid are exactly zero under zeros padding
    mask = ((x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) & (y0 <= h - 1)
            & (z0 >= -1) & (z0 <= d - 1))
    xp = (x0 + 1).clamp(0, w)
    yp = (y0 + 1).clamp(0, h)
    zp = (z0 + 1).clamp(0, d)
    rows = table[(zp * hp + yp) * wp + xp]  # (N, 8C)

    wzs, wys, wxs = (1 - fz, fz), (1 - fy, fy), (1 - fx, fx)
    m = mask.to(dt)
    out = None
    for k in range(8):
        dz, dy, dx = (k >> 2) & 1, (k >> 1) & 1, k & 1
        wk = (wzs[dz] * wys[dy] * wxs[dx] * m)[:, None]
        term = rows[:, k * c:(k + 1) * c].to(dt) * wk
        out = term if out is None else out + term
    return out.reshape(*batch_shape, c)


def grid_sample_3d_fast(grid: torch.Tensor, coords: torch.Tensor,
                        table_dtype=None) -> torch.Tensor:
    """grid_sample_3d through a table built for this one call (one-shot
    programs only; hot paths pass a prebuilt table)."""
    return sample_zexp_table(build_zexp_table(grid, table_dtype), grid.shape,
                             coords)

