"""Phase-2 pair building over the shared native/pairs.cc (counterpart of
sam_road_tpu/inference/pairs.py:build_pairs_for_boxes).

Per patch box: the vertices inside it (inclusive), their patch-local float32
coordinates, and each vertex's nearest neighbours strictly within `radius`
(distance, then index, breaks ties; self excluded). The C++ library is
built at first use and a failed build raises (no scipy fallback).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from sam_road_tpu_torch._native import build_and_load, native_source


@functools.cache
def _lib():
    dll = build_and_load(
        "samroad_pairs", "g++", ["-O2", "-shared", "-fPIC", "-std=c++17"],
        [native_source("pairs.cc")])
    dll.samroad_build_pairs.restype = ctypes.c_int64
    dll.samroad_build_pairs.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_double, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    return dll


def build_pairs_for_boxes(graph_points, boxes, max_nbr: int, radius: float,
                          cap: int = 512):
    """For each box (x0, y0, x1, y1), returns (pidx [m] int64, pts [m, 2]
    float32, pairs [m, max_nbr, 2] int32, valid [m, max_nbr] bool).
    Degenerate boxes (x1 < x0) and an empty vertex set yield empties."""
    graph_points = np.ascontiguousarray(graph_points, dtype=np.float64)
    boxes = np.ascontiguousarray(boxes, dtype=np.float64).reshape(-1, 4)
    nb = boxes.shape[0]
    if graph_points.shape[0] == 0:
        return [(np.zeros(0, np.int64), np.zeros((0, 2), np.float32),
                 np.zeros((0, max_nbr, 2), np.int32),
                 np.zeros((0, max_nbr), bool)) for _ in range(nb)]
    graph_points = graph_points.reshape(-1, 2)
    while True:
        counts = np.zeros(nb, np.int32)
        pidx = np.zeros((nb, cap), np.int64)
        pts = np.zeros((nb, cap, 2), np.float32)
        pairs = np.zeros((nb, cap, max_nbr, 2), np.int32)
        valid = np.zeros((nb, cap, max_nbr), np.uint8)
        got = _lib().samroad_build_pairs(
            graph_points.ctypes.data, graph_points.shape[0],
            boxes.ctypes.data, nb, max_nbr, float(radius), cap,
            counts.ctypes.data, pidx.ctypes.data, pts.ctypes.data,
            pairs.ctypes.data, valid.ctypes.data,
        )
        if got <= cap:
            break
        cap = int(got)  # a box held more vertices than cap: retry larger
    return [
        (pidx[b, :counts[b]].copy(), pts[b, :counts[b]].copy(),
         pairs[b, :counts[b]].copy(), valid[b, :counts[b]].astype(bool))
        for b in range(nb)
    ]
