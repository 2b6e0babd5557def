"""The TOPO metric on a synthetic 2048 px city tile (counterpart of the
repository's tools/profile_topo.py): a jittered street grid (spacing 128
px, a node every 8 px along the roads, like the Cityscale ground-truth
pickles) as the ground truth (seed 0), a perturbed copy (seed 1, jitter
1.5 px, 6 % of the streets dropped) as the proposal, and the port's
metrics/topo.py::topo_score_one_tile timed by the host clock, or under
cProfile with --profile. Host code: no device, no --device.

    python -m sam_road_tpu_torch.tools.profile_topo [--size 2048] [--profile]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def make_city_adj(size=2048, spacing=128, node_step=8, seed=0, jitter=0.0, drop_frac=0.0):
    """Jittered street grid as a sat2graph adjacency dict {(r,c): [(r,c)..]}."""
    rng = np.random.default_rng(seed)
    adj = {}

    def add_edge(a, b):
        adj.setdefault(a, [])
        adj.setdefault(b, [])
        if b not in adj[a]:
            adj[a].append(b)
        if a not in adj[b]:
            adj[b].append(a)

    lines = []
    for y in range(spacing // 2, size, spacing):  # horizontal streets
        lines.append([(int(round(y + jitter * rng.normal())), int(x))
                      for x in range(0, size + 1, node_step)])
    for x in range(spacing // 2, size, spacing):  # vertical streets
        lines.append([(int(y), int(round(x + jitter * rng.normal())))
                      for y in range(0, size + 1, node_step)])
    keep = rng.random(len(lines)) >= drop_frac
    for pts, k in zip(lines, keep):
        if k:
            for a, b in zip(pts, pts[1:]):
                add_edge(a, b)
    return adj


def main(size: int = 2048, profile: bool = False) -> dict:
    """Scores the proposal against the ground truth at `size`; returns and
    prints P, R, F1, the node counts and the seconds of the scoring."""
    from sam_road_tpu_torch.metrics.topo import topo_score_one_tile

    gt = make_city_adj(size=size, seed=0)
    prop = make_city_adj(size=size, seed=1, jitter=1.5, drop_frac=0.06)
    print(f"gt nodes={len(gt)} prop nodes={len(prop)}", flush=True)
    t = time.perf_counter()
    if profile:
        import cProfile
        import pstats

        pr = cProfile.Profile()
        pr.enable()
        p, r, f1 = topo_score_one_tile(gt, prop)
        pr.disable()
        seconds = time.perf_counter() - t
        pstats.Stats(pr).sort_stats("cumulative").print_stats(25)
    else:
        p, r, f1 = topo_score_one_tile(gt, prop)
        seconds = time.perf_counter() - t
    result = {"size": size, "gt_nodes": len(gt), "prop_nodes": len(prop), "precision": p,
              "recall": r, "f1": f1, "seconds": seconds, "profiled": profile}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--size", type=int, default=2048)
    args = ap.parse_args()
    main(args.size, args.profile)
