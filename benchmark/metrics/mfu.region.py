"""The whole region's share of the card's bf16 peak, in %: the model
operations of a region over region_s (the window's seconds over its
regions), at 989 TFLOP/s.

Operations (benchmark/counts.py): the encoder and the map decoder over
every patch, and TopoNet over every patch's vertices, each with
MAX_NEIGHBOR_QUERIES pair slots (the model's input per point); the vertex
counts are those of the window's outputs."""

import numpy as np

from benchmark import counts
from benchmark.reference.region import patch_grid


def read(run):
    if run["kind"] != "region" or not run["outputs"]:
        return None
    arch, cfg = run["arch"], run["cfg"]
    p, K = int(cfg["PATCH_SIZE"]), int(cfg["MAX_NEIGHBOR_QUERIES"])
    per_patch = counts.encoder_flops(arch) + counts.decoder_flops(arch)
    total = 0.0
    for nodes, _, kp, _ in run["outputs"]:
        origins = patch_grid(kp.shape[0], cfg["SAMPLE_MARGIN"], p, cfg["INFER_PATCHES_PER_EDGE"])
        yx = np.asarray(nodes).reshape(-1, 2)
        points = sum(int(((yx[:, 1] >= x0) & (yx[:, 1] <= x0 + p) & (yx[:, 0] >= y0)
                          & (yx[:, 0] <= y0 + p)).sum()) for x0, y0 in origins)
        total += len(origins) * per_patch + counts.toponet_flops(arch, points, points * K, K)
    return 100.0 * total / run["window_s"] / counts.PEAK_FLOPS
