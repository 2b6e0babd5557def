"""Crop RNGDet-format competitor predictions by a margin (counterpart of
sam_road_tpu/metrics/spacenet_convert.py; reference:
spacenet_metrics/spacenet_convert.py:13-37 — utility for evaluating
third-party outputs on the same TOPO/APLS suite)."""

from __future__ import annotations

import os
import pickle


def crop_prediction(graph: dict, margin: int = 24, image_size: int = 400) -> dict:
    """Drop nodes (and their edges) within `margin` px of the tile border."""
    lo, hi = margin, image_size - margin

    def inside(n):
        return lo <= n[0] <= hi and lo <= n[1] <= hi

    out = {}
    for node, neighbors in graph.items():
        if not inside(node):
            continue
        kept = [n for n in neighbors if inside(n)]
        if kept:
            out[node] = kept
    return out


def crop_prediction_dir(in_dir: str, out_dir: str, margin: int = 24,
                        image_size: int = 400):
    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(in_dir):
        if not name.endswith(".p"):
            continue
        with open(os.path.join(in_dir, name), "rb") as f:
            graph = pickle.load(f)
        cropped = crop_prediction(graph, margin, image_size)
        with open(os.path.join(out_dir, name), "wb") as f:
            pickle.dump(cropped, f)
