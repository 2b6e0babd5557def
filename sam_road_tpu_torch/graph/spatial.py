"""Uniform-grid spatial indexes over static point and rectangle sets
(counterpart of sam_road_tpu/graph/spatial.py, line for line).

Both query patterns the label generator and crossover search need are box
intersection over a static set, which a bucketed uniform grid answers with
numpy gathers.
"""

from __future__ import annotations

import numpy as np

_EMPTY = np.zeros((0,), dtype=np.int64)
_EMPTY.setflags(write=False)


class PointGridIndex:
    """Static point set with inclusive box queries: query_box((x0, y0, x1,
    y1)) returns the indices of the points with x0 <= x <= x1 and
    y0 <= y <= y1 (rtree's semantics for point entries)."""

    def __init__(self, points, cell_size: float = 64.0):
        self.points = np.asarray(points, dtype=np.float64).reshape(-1, 2)
        self.cell = float(cell_size)
        if self.points.shape[0] == 0:
            self._order = _EMPTY
            self._keys_sorted = _EMPTY
            return
        cx = np.floor(self.points[:, 0] / self.cell).astype(np.int64)
        cy = np.floor(self.points[:, 1] / self.cell).astype(np.int64)
        self._xmin, self._ymin = cx.min(), cy.min()
        cx -= self._xmin
        cy -= self._ymin
        self._nx = int(cx.max()) + 1
        self._ny = int(cy.max()) + 1
        keys = cx * self._ny + cy
        self._order = np.argsort(keys, kind="stable")
        self._keys_sorted = keys[self._order]

    def query_box(self, box) -> np.ndarray:
        """Indices of points inside the inclusive box (x0, y0, x1, y1)."""
        x0, y0, x1, y1 = box
        if self.points.shape[0] == 0:
            return _EMPTY
        cx0 = max(int(np.floor(x0 / self.cell)) - self._xmin, 0)
        cy0 = max(int(np.floor(y0 / self.cell)) - self._ymin, 0)
        cx1 = min(int(np.floor(x1 / self.cell)) - self._xmin, self._nx - 1)
        cy1 = min(int(np.floor(y1 / self.cell)) - self._ymin, self._ny - 1)
        if cx1 < cx0 or cy1 < cy0:
            return _EMPTY
        chunks = []
        for cx in range(cx0, cx1 + 1):
            lo = np.searchsorted(self._keys_sorted, cx * self._ny + cy0, side="left")
            hi = np.searchsorted(self._keys_sorted, cx * self._ny + cy1, side="right")
            if hi > lo:
                chunks.append(self._order[lo:hi])
        if not chunks:
            return _EMPTY
        cand = np.concatenate(chunks)
        p = self.points[cand]
        inside = (p[:, 0] >= x0) & (p[:, 0] <= x1) & (p[:, 1] >= y0) & (p[:, 1] <= y1)
        return cand[inside]


class RectGridIndex:
    """Static rectangle set ([N, 4] (x0, y0, x1, y1), x0 <= x1, y0 <= y1)
    with box-intersection queries: each rect is entered in every grid cell
    it covers; a query gathers the cells the box covers and filters by exact
    bbox intersection."""

    def __init__(self, rects, cell_size: float | None = None):
        self.rects = np.asarray(rects, dtype=np.float64).reshape(-1, 4)
        n = self.rects.shape[0]
        if n == 0:
            self.cell = 1.0
            self._entries = _EMPTY
            self._keys_sorted = _EMPTY
            return
        if cell_size is None:
            spans = np.maximum(self.rects[:, 2] - self.rects[:, 0],
                               self.rects[:, 3] - self.rects[:, 1])
            cell_size = max(float(np.median(spans)) * 2.0, 1e-6)
        self.cell = float(cell_size)

        cx0 = np.floor(self.rects[:, 0] / self.cell).astype(np.int64)
        cy0 = np.floor(self.rects[:, 1] / self.cell).astype(np.int64)
        cx1 = np.floor(self.rects[:, 2] / self.cell).astype(np.int64)
        cy1 = np.floor(self.rects[:, 3] / self.cell).astype(np.int64)
        self._xmin, self._ymin = int(cx0.min()), int(cy0.min())
        cx0 -= self._xmin
        cy0 -= self._ymin
        cx1 -= self._xmin
        cy1 -= self._ymin
        self._nx = int(cx1.max()) + 1
        self._ny = int(cy1.max()) + 1

        # each rect expanded into its covered cells
        nx_cells = cx1 - cx0 + 1
        ny_cells = cy1 - cy0 + 1
        counts = nx_cells * ny_cells
        total = int(counts.sum())
        rect_ids = np.repeat(np.arange(n), counts)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        local = np.arange(total) - np.repeat(starts, counts)
        lx = local // ny_cells[rect_ids]
        ly = local % ny_cells[rect_ids]
        keys = (cx0[rect_ids] + lx) * self._ny + (cy0[rect_ids] + ly)
        order = np.argsort(keys, kind="stable")
        self._entries = rect_ids[order]
        self._keys_sorted = keys[order]

    def query_box(self, box) -> np.ndarray:
        """Indices of rects whose bbox intersects the (inclusive) query box."""
        x0, y0, x1, y1 = box
        if self.rects.shape[0] == 0:
            return _EMPTY
        cx0 = max(int(np.floor(x0 / self.cell)) - self._xmin, 0)
        cy0 = max(int(np.floor(y0 / self.cell)) - self._ymin, 0)
        cx1 = min(int(np.floor(x1 / self.cell)) - self._xmin, self._nx - 1)
        cy1 = min(int(np.floor(y1 / self.cell)) - self._ymin, self._ny - 1)
        if cx1 < cx0 or cy1 < cy0:
            return _EMPTY
        chunks = []
        for cx in range(cx0, cx1 + 1):
            lo = np.searchsorted(self._keys_sorted, cx * self._ny + cy0, side="left")
            hi = np.searchsorted(self._keys_sorted, cx * self._ny + cy1, side="right")
            if hi > lo:
                chunks.append(self._entries[lo:hi])
        if not chunks:
            return _EMPTY
        cand = np.unique(np.concatenate(chunks))
        r = self.rects[cand]
        hit = (r[:, 0] <= x1) & (r[:, 2] >= x0) & (r[:, 1] <= y1) & (r[:, 3] >= y0)
        return cand[hit]
