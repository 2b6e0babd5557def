"""Greedy score-ordered point NMS over the port's csrc/nms.cc
(counterpart of sam_road_tpu/graph/nms.py).

Points are visited in descending score order (np.argsort(scores)[::-1]); a
still-kept point suppresses every neighbour within `radius` except those with
score > 1.0. Those immune points never enter the native pass's neighbour
grid, so where every score is above 1.0 (uint8 mask values) the pass does no
neighbourhood work at all. The C++ library is built at first use and a
failed build raises (the JAX package falls back to numpy; the port does not).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import os

import numpy as np

from sam_road_tpu_torch._native import PKG_DIR, build_and_load

# Points over the process: "candidates" into nms_points, "suppressible"
# (score <= 1.0) into the native pass's grid. TiledInferenceEngine._finish
# reads the difference around a region's extraction.
counts: collections.Counter = collections.Counter()


@functools.cache
def _lib():
    dll = build_and_load(
        "samroad_nms", "g++", ["-O3", "-shared", "-fPIC", "-std=c++17"],
        [os.path.join(PKG_DIR, "csrc", "nms.cc")])
    dll.samroad_nms.restype = ctypes.c_int64
    dll.samroad_nms.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
    ]
    return dll


def nms_points(points, scores, radius, return_indices: bool = False):
    """Greedy radius NMS; scores > 1.0 are immune to suppression.

    Returns the kept points [M, 2] in descending score order and, with
    return_indices, their indices into the inputs."""
    points = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    scores = np.asarray(scores, dtype=np.float64).reshape(-1)
    if points.shape[0] != scores.shape[0]:
        raise ValueError(f"{points.shape[0]} points but {scores.shape[0]} scores")
    n = points.shape[0]
    counts["candidates"] += n
    if n == 0:
        empty = points.reshape(0, 2)
        return (empty, np.zeros(0, dtype=np.int64)) if return_indices else empty
    order = np.argsort(scores)[::-1]
    pts = np.ascontiguousarray(points[order])
    sc = np.ascontiguousarray(scores[order])
    kept = np.zeros(n, dtype=np.uint8)
    in_grid = ctypes.c_int64(0)
    _lib().samroad_nms(pts.ctypes.data, sc.ctypes.data, n, float(radius),
                       kept.ctypes.data, ctypes.byref(in_grid))
    counts["suppressible"] += in_grid.value
    kept = kept.astype(bool)
    if return_indices:
        return pts[kept], order[kept]
    return pts[kept]
