"""Isosurface extraction + PLY export for shape extraction (the port's own
copy of fenerf_tpu/utils/marching.py, numpy only).

The reference pipeline writes sigma volumes as .mrc and meshes them
externally (extract_shapes.py imports skimage.measure / plyfile; this needs
neither). This module provides a self-contained mesher using
MARCHING TETRAHEDRA: each voxel cell splits into 6 tetrahedra; a tet with k
corners above the iso level contributes 0/1/2 triangles whose vertices are
edge interpolations — no 256-entry case table required, and the surface is
watertight across cells. Vectorized numpy.
"""
from __future__ import annotations

import os

import numpy as np

# 6-tetrahedra decomposition of the unit cube (corner indices into the
# standard corner ordering below); all share the main diagonal 0-7 so faces
# match between neighboring tets and cells
_CUBE_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], dtype=np.int64)
_TETS = np.array([
    [0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
    [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6],
], dtype=np.int64)


def _tet_triangles(values, verts, level):
    """Triangulate one batch of tetrahedra.

    values: (N, 4) corner scalar values; verts: (N, 4, 3) corner positions.
    Returns (M, 3, 3) triangle vertices.
    """
    inside = values > level  # (N, 4)
    code = (inside * (1 << np.arange(4))).sum(axis=1)

    tris = []

    def edge_point(vi, vj):
        a = values[sel, vi]
        b = values[sel, vj]
        t = (level - a) / np.where(np.abs(b - a) < 1e-12, 1e-12, b - a)
        t = np.clip(t, 0.0, 1.0)[:, None]
        return verts[sel, vi] * (1 - t) + verts[sel, vj] * t

    # enumerate the 14 non-trivial sign patterns; single-corner cases give
    # one triangle, two-corner cases give a quad (two triangles)
    for c in range(1, 15):
        sel = np.nonzero(code == c)[0]
        if sel.size == 0:
            continue
        ins = [i for i in range(4) if c & (1 << i)]
        outs = [i for i in range(4) if not c & (1 << i)]
        if len(ins) == 3:  # symmetric to one-outside
            ins, outs = outs, ins
        if len(ins) == 1:
            i = ins[0]
            p = [edge_point(i, o) for o in outs]
            tris.append(np.stack([p[0], p[1], p[2]], axis=1))
        else:  # 2 in / 2 out -> quad
            i0, i1 = ins
            o0, o1 = outs
            a = edge_point(i0, o0)
            b = edge_point(i0, o1)
            cc = edge_point(i1, o1)
            d = edge_point(i1, o0)
            tris.append(np.stack([a, b, cc], axis=1))
            tris.append(np.stack([a, cc, d], axis=1))
    if not tris:
        return np.zeros((0, 3, 3), np.float32)
    return np.concatenate(tris, axis=0).astype(np.float32)


def marching_tetrahedra(volume: np.ndarray, level: float,
                        spacing: tuple[float, float, float] = (1, 1, 1),
                        origin: tuple[float, float, float] = (0, 0, 0),
                        max_cells_per_batch: int = 2_000_000):
    """volume (nz, ny, nx) -> (vertices (V, 3), faces (F, 3)).

    Only cells straddling the level are triangulated; vertices are de-duped
    by quantized position so the mesh is watertight.
    """
    vol = np.asarray(volume, np.float32)
    nz, ny, nx = vol.shape
    # cells whose 8 corners straddle the level
    c = vol
    mx = np.maximum.reduce([
        c[:-1, :-1, :-1], c[1:, :-1, :-1], c[:-1, 1:, :-1], c[:-1, :-1, 1:],
        c[1:, 1:, :-1], c[1:, :-1, 1:], c[:-1, 1:, 1:], c[1:, 1:, 1:]])
    mn = np.minimum.reduce([
        c[:-1, :-1, :-1], c[1:, :-1, :-1], c[:-1, 1:, :-1], c[:-1, :-1, 1:],
        c[1:, 1:, :-1], c[1:, :-1, 1:], c[:-1, 1:, 1:], c[1:, 1:, 1:]])
    zz, yy, xx = np.nonzero((mn <= level) & (mx > level))
    if zz.size == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    all_tris = []
    for s in range(0, zz.size, max_cells_per_batch):
        z, y, x = zz[s:s + max_cells_per_batch], yy[s:s + max_cells_per_batch], \
            xx[s:s + max_cells_per_batch]
        base = np.stack([x, y, z], axis=1)  # (C, 3) in xyz order
        corners = base[:, None, :] + _CUBE_CORNERS[None]  # (C, 8, 3) xyz
        vals = vol[corners[..., 2], corners[..., 1], corners[..., 0]]  # (C,8)
        pos = corners.astype(np.float32)
        for tet in _TETS:
            all_tris.append(_tet_triangles(vals[:, tet], pos[:, tet], level))
    tris = np.concatenate(all_tris, axis=0)  # (M, 3, 3) xyz in voxel coords

    # weld vertices (quantize to kill float jitter on shared edges)
    flat = tris.reshape(-1, 3)
    key = np.round(flat * 1024.0).astype(np.int64)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    # representative positions: first occurrence
    first = np.zeros(len(uniq), np.int64)
    seen = np.full(len(uniq), -1, np.int64)
    order = np.arange(len(inv))
    np.minimum.at(seen, inv, order)
    verts = flat[seen]
    faces = inv.reshape(-1, 3)
    # drop degenerate faces
    good = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) \
        & (faces[:, 0] != faces[:, 2])
    faces = faces[good]

    sp = np.asarray(spacing, np.float32)
    og = np.asarray(origin, np.float32)
    return verts * sp[None] + og[None], faces


# ---------------------------------------------------------------------------
# Classic marching cubes (Lorensen & Cline 1987 case structure).
#
# The reference meshes its sigma volumes with skimage marching cubes
# (reference extract_shapes.py:1-8 imports skimage.measure), producing the
# standard shared-vertex cube meshes. Without skimage, the 256-entry case
# table is GENERATED at first use by polygon tracing:
# for each corner-sign configuration, the cut edges are paired per face and
# the resulting degree-2 graph traced into closed polygons, then fanned into
# triangles. Ambiguous faces (4 cut edges) use a fixed geometric pairing
# (group the two edges touching the face's lowest-numbered corner), which is
# identical from both sides of a shared face — so unlike the classic table,
# complementary ambiguous neighbors can never open a crack: the mesh is
# watertight by construction. Vertices are shared exactly via global grid
# edge identity (one vertex per cut lattice edge), like skimage's output.
# ---------------------------------------------------------------------------

# standard MC corner numbering, offsets in (x, y, z)
_MC_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], dtype=np.int64)
# standard MC edge numbering: (corner, corner)
_MC_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]
# cube faces as (corner quad in cyclic order, its edges in the same order)
_MC_FACES = [((0, 1, 2, 3), (0, 1, 2, 3)), ((4, 5, 6, 7), (4, 5, 6, 7)),
             ((0, 1, 5, 4), (0, 9, 4, 8)), ((3, 2, 6, 7), (2, 10, 6, 11)),
             ((0, 3, 7, 4), (3, 11, 7, 8)), ((1, 2, 6, 5), (1, 10, 5, 9))]

_MC_TABLE_CACHE = None


def _build_mc_table():
    """(256, maxT, 3) int8 table of triangle edge-id triples, -1 padded.

    Triangles are oriented so normals point from the inside (> level) region
    toward the outside, i.e. outward for a solid blob.
    """
    mid = {e: (_MC_CORNERS[a] + _MC_CORNERS[b]) / 2.0
           for e, (a, b) in enumerate(_MC_EDGES)}
    cases = []
    for code in range(256):
        inside = [(code >> i) & 1 for i in range(8)]
        cut = {e for e, (a, b) in enumerate(_MC_EDGES)
               if inside[a] != inside[b]}
        # pair cut edges per face -> each cut edge gets exactly 2 partners
        partners = {e: [] for e in cut}
        for quad, feds in _MC_FACES:
            fcut = [e for e in feds if e in cut]
            if not fcut:
                continue
            if len(fcut) == 2:
                pairs = [fcut]
            else:  # ambiguous face: all 4 edges cut (diagonal corner states)
                # pairing must be keyed on GEOMETRIC corner identity (the
                # (z, y, x)-lexicographic minimum offset), which both cells
                # sharing the face agree on — the local corner INDEX maps to
                # different geometric corners from the two sides and would
                # crack the mesh on complementary ambiguous neighbors
                cmin = min(quad, key=lambda c: tuple(_MC_CORNERS[c][::-1]))
                adj = [e for e in feds if cmin in _MC_EDGES[e]]
                pairs = [adj, [e for e in feds if e not in adj]]
            for a, b in pairs:
                partners[a].append(b)
                partners[b].append(a)
        # trace closed polygons through the degree-2 adjacency
        tris = []
        seen = set()
        for start in sorted(cut):
            if start in seen:
                continue
            cyc = [start]
            prev, cur = None, start
            while True:
                nxt = [p for p in partners[cur] if p != prev]
                nxt = nxt[0] if nxt else partners[cur][0]
                if nxt == start:
                    break
                cyc.append(nxt)
                prev, cur = cur, nxt
            seen.update(cyc)
            if len(cyc) < 3:
                continue
            pts = np.array([mid[e] for e in cyc])
            # Newell normal of the polygon as ordered
            n = np.cross(pts, np.roll(pts, -1, axis=0)).sum(axis=0)
            # should point inside -> outside: majority vote over cut edges
            score = 0.0
            for e in cyc:
                a, b = _MC_EDGES[e]
                if not inside[a]:
                    a, b = b, a
                score += float(n @ (_MC_CORNERS[b] - _MC_CORNERS[a]))
            if score < 0:
                cyc = cyc[::-1]
            # fan root: prefer a rotation whose chords don't lie on a cube
            # face — a face-coplanar chord can coincide with the neighbor
            # cell's chord, leaving a (harmless but non-manifold) 4-face edge
            def n_coplanar(rot):
                c = cyc[rot:] + cyc[:rot]
                return sum(
                    any(c[0] in feds and c[k] in feds
                        for _, feds in _MC_FACES)
                    for k in range(2, len(c) - 1))
            best = min(range(len(cyc)), key=n_coplanar)
            cyc = cyc[best:] + cyc[:best]
            for k in range(1, len(cyc) - 1):
                tris.append((cyc[0], cyc[k], cyc[k + 1]))
        cases.append(tris)
    maxt = max(len(t) for t in cases)
    table = np.full((256, maxt, 3), -1, np.int8)
    for code, tris in enumerate(cases):
        for k, t in enumerate(tris):
            table[code, k] = t
    return table


def _mc_table():
    global _MC_TABLE_CACHE
    if _MC_TABLE_CACHE is None:
        _MC_TABLE_CACHE = _build_mc_table()
    return _MC_TABLE_CACHE


def _axis_edge_vertices(vol, inside, level, axis):
    """Vertex positions + an id volume for cut lattice edges along one axis.

    axis: 0=x, 1=y, 2=z (edge direction in xyz). Returns (pos (K, 3) float32
    in voxel xyz coords, ids (edge-grid shape) int64 with -1 where uncut).
    """
    ax_zyx = 2 - axis  # volume is indexed [z, y, x]
    sl0 = [slice(None)] * 3
    sl1 = [slice(None)] * 3
    sl0[ax_zyx] = slice(None, -1)
    sl1[ax_zyx] = slice(1, None)
    v0, v1 = vol[tuple(sl0)], vol[tuple(sl1)]
    cutm = inside[tuple(sl0)] != inside[tuple(sl1)]
    ids = np.full(cutm.shape, -1, np.int64)
    zz, yy, xx = np.nonzero(cutm)
    ids[zz, yy, xx] = np.arange(zz.size)
    a, b = v0[zz, yy, xx], v1[zz, yy, xx]
    d = b - a
    t = (level - a) / np.where(np.abs(d) < 1e-30, 1e-30, d)
    t = np.clip(t, 0.0, 1.0).astype(np.float32)
    pos = np.stack([xx, yy, zz], axis=1).astype(np.float32)
    pos[:, axis] += t
    return pos, ids


def marching_cubes(volume: np.ndarray, level: float,
                   spacing: tuple[float, float, float] = (1, 1, 1),
                   origin: tuple[float, float, float] = (0, 0, 0)):
    """volume (nz, ny, nx) -> (vertices (V, 3) xyz, faces (F, 3)).

    Classic cube meshing with exact vertex sharing (one vertex per cut
    lattice edge) and outward-oriented faces; watertight by construction
    (see the table-generation notes above).
    """
    vol = np.asarray(volume, np.float32)
    inside = vol > level

    verts_parts, eids = [], []
    off = 0
    for axis in range(3):
        pos, ids = _axis_edge_vertices(vol, inside, level, axis)
        ids = np.where(ids >= 0, ids + off, -1)
        off += len(pos)
        verts_parts.append(pos)
        eids.append(ids)
    if off == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    verts = np.concatenate(verts_parts, axis=0)
    ex, ey, ez = eids

    # candidate cells: any corner-sign change
    i8 = [inside[cz:cz + vol.shape[0] - 1, cy:cy + vol.shape[1] - 1,
                 cx:cx + vol.shape[2] - 1]
          for cx, cy, cz in _MC_CORNERS]
    code_vol = sum(c.astype(np.int64) << k for k, c in enumerate(i8))
    zz, yy, xx = np.nonzero((code_vol > 0) & (code_vol < 255))
    if zz.size == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    code = code_vol[zz, yy, xx]

    # per-cell map: local edge id (12) -> global vertex id
    emap = np.stack([
        ex[zz, yy, xx], ey[zz, yy, xx + 1], ex[zz, yy + 1, xx],
        ey[zz, yy, xx], ex[zz + 1, yy, xx], ey[zz + 1, yy, xx + 1],
        ex[zz + 1, yy + 1, xx], ey[zz + 1, yy, xx],
        ez[zz, yy, xx], ez[zz, yy, xx + 1], ez[zz, yy + 1, xx + 1],
        ez[zz, yy + 1, xx],
    ], axis=1)  # (C, 12)

    tri = _mc_table()[code].astype(np.int64)          # (C, maxT, 3)
    valid = tri[:, :, 0] >= 0
    faces = np.take_along_axis(
        emap[:, :, None], tri.reshape(len(code), -1, 1).clip(0), axis=1)
    faces = faces.reshape(tri.shape)[valid]           # (F, 3)

    sp = np.asarray(spacing, np.float32)
    og = np.asarray(origin, np.float32)
    return verts * sp[None] + og[None], faces


def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Minimal binary-less ASCII PLY writer (plyfile replacement)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in vertices:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces:
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")
