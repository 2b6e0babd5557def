"""The host extraction and phase 2 of the bench region, split (counterpart
of the repository's tools/profile_extract_p2.py).

After the bench's calibration (tools/bench.py) and one run at its
thresholds:
  extraction  on the run's fetched masks, `reps` times: the keypoint
              threshold (np.where over the region), keypoint NMS, the road
              threshold, road NMS and the final NMS over their union, with
              the candidates and survivors of each (graph/extraction.py and
              graph/nms.py, the passes of `extract_graph_points`, whose
              points the split's final points must equal);
  phase 2     `reps` times, from a fresh phase 1 and extraction: the host's
              pair building and the dispatch of every batch
              (`engine._dispatch_phase2`, its p2_build / p2_dispatch split
              beside), the wait for the card's queue to drain (a
              synchronise), the copy of the int16 score stacks to the host
              with the queue empty (MB and batches), then the engine's own
              grouped fetch-and-select (`_collect_scores`, which copies them
              again; its p2_fetch beside) and its int64 aggregation
              (`_aggregate_edges`), whose edges must equal the run's.

Host clocks around each step (a synchronise where the card works). The JAX
tool's link fencing has no counterpart on the card and is left out.

    python -m sam_road_tpu_torch.tools.profile_extract_p2 [--reps 3] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from sam_road_tpu_torch.tools import bench


def extraction_split(kp_mask, road_mask, cfg):
    """extract_graph_points's passes, timed: (row, final points [N, 2])."""
    from sam_road_tpu_torch.graph.extraction import get_points_and_scores_from_mask
    from sam_road_tpu_torch.graph.nms import nms_points

    t0 = time.perf_counter()
    kp_c, kp_s = get_points_and_scores_from_mask(kp_mask, cfg.ITSC_THRESHOLD * 255)
    t1 = time.perf_counter()
    kps_0 = nms_points(kp_c, kp_s, cfg.ITSC_NMS_RADIUS)
    t2 = time.perf_counter()
    rd_c, rd_s = get_points_and_scores_from_mask(road_mask, cfg.ROAD_THRESHOLD * 255)
    t3 = time.perf_counter()
    kps_1 = nms_points(rd_c, rd_s, cfg.ROAD_NMS_RADIUS)
    t4 = time.perf_counter()
    cand = np.concatenate([kps_0, kps_1], axis=0)
    prio = np.concatenate([np.ones((kps_0.shape[0],)), np.zeros((kps_1.shape[0],))])
    final = nms_points(cand, prio, cfg.ROAD_NMS_RADIUS)
    t5 = time.perf_counter()
    row = dict(kp_thresh_s=t1 - t0, kp_candidates=int(kp_c.shape[0]), kp_nms_s=t2 - t1,
               kp_kept=int(kps_0.shape[0]), road_thresh_s=t3 - t2,
               road_candidates=int(rd_c.shape[0]), road_nms_s=t4 - t3,
               road_kept=int(kps_1.shape[0]), final_nms_s=t5 - t4,
               vertices=int(final.shape[0]), total_s=t5 - t0)
    return row, final


def phase2_split(engine, img) -> dict:
    """One region's phase 2 through the engine's methods, step by step."""
    from sam_road_tpu_torch.graph.extraction import extract_graph_points

    dev = engine.device
    p1 = engine._run_phase1(img)
    masks = engine._fetch_masks(p1)
    graph_points = extract_graph_points(np.ascontiguousarray(masks[..., 0]),
                                        np.ascontiguousarray(masks[..., 1]), engine.config)
    fine = {}  # the engine's spans add p2_build, p2_dispatch, p2_fetch
    t0 = time.perf_counter()
    pending, _ = engine._dispatch_phase2(p1["batches"], graph_points, fine)
    t1 = time.perf_counter()
    bench.sync(dev)
    t2 = time.perf_counter()
    stacks = [q[..., 0].cpu() for q, _ in pending]
    t3 = time.perf_counter()
    scored = engine._collect_scores(pending, fine)
    t4 = time.perf_counter()
    edges = engine._aggregate_edges(scored, graph_points.shape[0])
    t5 = time.perf_counter()
    return dict(build_dispatch_s=t1 - t0, queue_drain_s=t2 - t1, pure_fetch_s=t3 - t2,
                fetch_mb=sum(s.numel() * s.element_size() for s in stacks) / 1e6,
                batches=len(pending), collect_s=t4 - t3, aggregate_s=t5 - t4,
                edges=int(edges.shape[0]), **fine)


def main(device: str = "cuda", *, reps: int = 3, model=None, overrides: dict | None = None,
         region: np.ndarray | None = None, seed: int = bench.SEED) -> dict:
    """Returns and prints the run's graph and timings, `extract` (one row a
    repetition) and `phase2` (one row a repetition). `model`, `overrides`
    (on top of the bench config) and `region` exist so that a test can run
    the tool small."""
    import torch

    from sam_road_tpu_torch.graph.extraction import extract_graph_points

    dev = bench.require_device(device)
    engine = bench.make_engine(dev, overrides, model, seed)
    img = bench.make_region() if region is None else region
    thresholds = bench.calibrate(engine, img)
    nodes, edges, kp, road = engine.infer_one_img(img)
    results = {"device": bench.device_name(dev), "thresholds": thresholds,
               "nodes": int(nodes.shape[0]), "edges": int(edges.shape[0]),
               "engine_timings": dict(engine.last_timings), "extract": [], "phase2": []}
    want = extract_graph_points(kp, road, engine.config)
    for _ in range(reps):
        row, final = extraction_split(kp, road, engine.config)
        if not np.array_equal(final, want):
            raise SystemExit("the extraction split's points differ from extract_graph_points's")
        results["extract"].append(row)
    with torch.no_grad():
        for _ in range(reps):
            row = phase2_split(engine, img)
            if row["edges"] != results["edges"]:
                raise SystemExit(f"the phase-2 split kept {row['edges']} edges, the run "
                                 f"{results['edges']}")
            results["phase2"].append(row)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args()
    main(args.device, reps=args.reps)
