"""Lightmap UVs for a triangle soup, made from its triangles alone as an
importer's auto-unwrap makes them (Unity's "Generate Lightmap UVs",
xatlas): a unique layout, so that no texel is written by two charts.

1. Charts: the triangles' geometric normals are binned by their dominant
   axis and its sign (six bins); triangles of one bin that share an edge
   (the same two float32 vertex positions) belong to one chart, taken as
   the connected components of that relation. Triangles of no area get
   no UVs (all zero: the bake's rasterizer skips them).
2. Each chart is projected onto its axis's plane, in metres, and turned
   so that its height is no more than its width.
3. At one world density (texels a metre) every chart becomes a rectangle
   of its texel points (one more where its extent is not whole, for the
   UVs' float32 rounding) plus GUTTER empty texels, and the rectangles are
   shelf-packed, the tallest first, left to right in rows.
4. The density is the largest that packs into the atlas (a bisection),
   so the charts fill it.

A chart's texel points lie in its rectangle, and the bake's rasterizer
tests only the points of a triangle's own UV box, so two charts never
share a texel; `cross_chart_texels` counts them on a rasterization.
"""

from __future__ import annotations

import numpy as np

#: empty texels between two charts' rectangles, and at the atlas's edges
GUTTER = 2
#: triangles with less area (m^2) get no UVs
MIN_AREA = 1e-12


def charts(positions: np.ndarray):
    """(chart id (n,) int64, -1 for a triangle of no area; the dominant
    axis of each chart (c,) int64)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    p = np.asarray(positions, np.float64)
    ng = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    real = np.linalg.norm(ng, axis=-1) * 0.5 >= MIN_AREA
    axis = np.argmax(np.abs(ng), axis=-1)
    label = axis * 2 + (ng[np.arange(len(p)), axis] >= 0)
    # vertex ids by exact float32 position, then each triangle's three edges
    _, vid = np.unique(np.asarray(positions, np.float32).reshape(-1, 3), axis=0,
                       return_inverse=True)
    vid = vid.reshape(-1, 3)
    a = vid[:, [0, 1, 2]].reshape(-1)
    b = vid[:, [1, 2, 0]].reshape(-1)
    edge = np.minimum(a, b) * (vid.max() + 1) + np.maximum(a, b)
    tri = np.repeat(np.arange(len(p)), 3)
    keep = real[tri]
    edge, tri = edge[keep], tri[keep]
    order = np.lexsort((label[tri], edge))
    edge, tri = edge[order], tri[order]
    same = (edge[1:] == edge[:-1]) & (label[tri[1:]] == label[tri[:-1]])
    n = len(p)
    graph = coo_matrix((np.ones(int(same.sum())), (tri[:-1][same], tri[1:][same])), shape=(n, n))
    _, comp = connected_components(graph, directed=False)
    ids = np.full(n, -1, np.int64)
    _, ids[real] = np.unique(comp[real], return_inverse=True)
    chart_axis = np.zeros(int(ids.max()) + 1, np.int64)
    chart_axis[ids[real]] = axis[real]
    return ids, chart_axis


def _shelf_pack(w: np.ndarray, h: np.ndarray, width: int, height: int):
    """Integer rectangles (w, h, gutters included) packed in rows, the
    tallest first: their (x, y) corners, or None if they do not fit."""
    order = np.argsort(-h, kind="stable")
    x = np.zeros(len(w), np.int64)
    y = np.zeros(len(w), np.int64)
    cx, cy, row = GUTTER, GUTTER, 0
    for i in order:
        if cx + w[i] > width:
            cx, cy, row = GUTTER, cy + row, 0
        if cx + w[i] > width or cy + h[i] > height:
            return None
        x[i], y[i] = cx, cy
        cx += w[i]
        row = max(row, h[i])
    return x, y


def atlas_uvs(positions: np.ndarray, width: int, height: int):
    """Lightmap UVs (n, 3, 2) float32 for the soup and what the layout
    holds: charts (their count), chart (each triangle's, -1 for none),
    texels_per_m (the density), fill (the charts' texel rectangles over
    the atlas, gutters left out)."""
    p = np.asarray(positions, np.float64)
    ids, axis = charts(p)
    real = ids >= 0
    # each vertex projected onto its chart's plane, in metres
    ax = axis[np.maximum(ids, 0)]
    u = np.take_along_axis(p, ((ax + 1) % 3)[:, None, None].repeat(3, 1), 2)[..., 0]
    v = np.take_along_axis(p, ((ax + 2) % 3)[:, None, None].repeat(3, 1), 2)[..., 0]
    nc = len(axis)
    lo_u = np.full(nc, np.inf)
    lo_v = np.full(nc, np.inf)
    hi_u = np.full(nc, -np.inf)
    hi_v = np.full(nc, -np.inf)
    rep = np.repeat(ids[real], 3)
    np.minimum.at(lo_u, rep, u[real].reshape(-1))
    np.minimum.at(lo_v, rep, v[real].reshape(-1))
    np.maximum.at(hi_u, rep, u[real].reshape(-1))
    np.maximum.at(hi_v, rep, v[real].reshape(-1))
    eu, ev = hi_u - lo_u, hi_v - lo_v
    turn = ev > eu
    eu, ev = np.where(turn, ev, eu), np.where(turn, eu, ev)

    def pack(density):
        # ceil: a corner that float32 rounds onto the next texel point stays inside
        w = np.ceil(eu * density).astype(np.int64) + 1 + GUTTER
        h = np.ceil(ev * density).astype(np.int64) + 1 + GUTTER
        return _shelf_pack(w, h, width, height)

    lo, hi = 0.0, float(np.sqrt(width * height / max((eu * ev).sum(), 1e-12)))
    while pack(hi) is not None:
        lo, hi = hi, hi * 2.0
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if pack(mid) is not None else (lo, mid)
    density = lo
    placed = pack(density)
    if placed is None:
        raise ValueError(f"{nc} charts do not fit a {width}x{height} atlas with {GUTTER} "
                         "texels of gutter")
    x, y = placed
    du = (u - lo_u[np.maximum(ids, 0)][:, None]) * density
    dv = (v - lo_v[np.maximum(ids, 0)][:, None]) * density
    t = turn[np.maximum(ids, 0)][:, None]
    tu, tv = np.where(t, dv, du), np.where(t, du, dv)
    uv = np.stack([(x[np.maximum(ids, 0)][:, None] + tu) / width,
                   (y[np.maximum(ids, 0)][:, None] + tv) / height], -1)
    uv[~real] = 0.0
    fill = float(((np.ceil(eu * density) + 1) * (np.ceil(ev * density) + 1)).sum()
                 / (width * height))
    return uv.astype(np.float32), {"charts": nc, "chart": ids, "texels_per_m": density,
                                   "fill": fill}


def cross_chart_texels(index: np.ndarray, chart: np.ndarray) -> int:
    """Texels written by triangles of more than one chart, from a
    rasterization's records (texel ids and each record's chart)."""
    if not len(index):
        return 0
    order = np.lexsort((chart, index))
    i, c = index[order], chart[order]
    first = np.r_[True, i[1:] != i[:-1]]
    start = np.flatnonzero(first)
    lo = c[start]
    hi = c[np.r_[start[1:], len(i)] - 1]
    return int((lo != hi).sum())
