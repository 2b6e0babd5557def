"""Exact 2D segment geometry (counterpart of sam_road_tpu/graph/geometry.py,
line for line): proper segment intersection with the endpoints excluded,
the crossover (overpass) points of a graph, and point-to-segment distance.
Crossover points mark overpasses whose vertices must not become keypoint
labels."""

from __future__ import annotations

import numpy as np

from sam_road_tpu_torch.graph.spatial import RectGridIndex

_ENDPOINT_EPS = 1e-9


def segments_intersect(p, p2, q, q2):
    """Batch proper-intersection test between segment pairs p-p2 and q-q2
    ([N, 2] each). Returns (hit [N] bool, pts [N, 2]): a hit is a single
    intersection point that coincides with none of the 4 endpoints."""
    p = np.asarray(p, dtype=np.float64)
    p2 = np.asarray(p2, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    q2 = np.asarray(q2, dtype=np.float64)
    r = p2 - p
    s = q2 - q
    denom = r[:, 0] * s[:, 1] - r[:, 1] * s[:, 0]
    qp = q - p
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (qp[:, 0] * s[:, 1] - qp[:, 1] * s[:, 0]) / denom
        u = (qp[:, 0] * r[:, 1] - qp[:, 1] * r[:, 0]) / denom
    nonparallel = np.abs(denom) > 0.0
    hit = nonparallel & (t >= 0.0) & (t <= 1.0) & (u >= 0.0) & (u <= 1.0)
    pts = p + t[:, None] * r
    for end in (p, p2, q, q2):
        hit &= np.abs(pts - end).max(axis=1) > _ENDPOINT_EPS
    return hit, pts


def find_crossover_points(graph) -> list:
    """Every interior intersection point between two edges of the graph:
    candidate pairs from a bbox-overlap index over the edges padded by 1 px,
    each unordered pair tested once, crossings at shared endpoints
    excluded."""
    points = graph.points
    edges = graph.edges
    if edges.shape[0] == 0:
        return []
    a = points[edges[:, 0]]
    b = points[edges[:, 1]]
    rects = np.stack([
        np.minimum(a[:, 0], b[:, 0]) - 1,
        np.minimum(a[:, 1], b[:, 1]) - 1,
        np.maximum(a[:, 0], b[:, 0]) + 1,
        np.maximum(a[:, 1], b[:, 1]) + 1,
    ], axis=1)
    index = RectGridIndex(rects)
    pair_i, pair_j = [], []
    for i in range(edges.shape[0]):
        nearby = index.query_box(rects[i])
        nearby = nearby[nearby > i]  # each unordered pair once; skip self
        if nearby.size:
            pair_i.append(np.full(nearby.shape, i, dtype=np.int64))
            pair_j.append(nearby)
    if not pair_i:
        return []
    pi = np.concatenate(pair_i)
    pj = np.concatenate(pair_j)
    hit, pts = segments_intersect(a[pi], b[pi], a[pj], b[pj])
    return [tuple(xy) for xy in pts[hit]]


def point_segment_distance(points, seg_a, seg_b):
    """Distance from each point to the segment (a, b); returns [N]
    distances and the projection parameter t (unclamped)."""
    points = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    a = np.asarray(seg_a, dtype=np.float64).reshape(2)
    b = np.asarray(seg_b, dtype=np.float64).reshape(2)
    ab = b - a
    denom = float(ab @ ab)
    if denom == 0.0:
        return np.linalg.norm(points - a[None, :], axis=1), np.zeros(points.shape[0])
    t = ((points - a[None, :]) @ ab) / denom
    proj = a[None, :] + np.clip(t, 0.0, 1.0)[:, None] * ab[None, :]
    return np.linalg.norm(points - proj, axis=1), t
