"""INFER_BATCH_SIZE sweep on the bench region (counterpart of the
repository's tools/experiment_infer_batch.py).

For each phase-1 batch size, with the fused encoder on (K1-K4) and off (the
eager encoder, K5), on one set of weights: the bench protocol
(tools/bench.py::run: a warm run, calibrated thresholds, a check run), then
the least of `runs` timed region runs with the best run's phase split, the
median, the peak device memory of the timed runs, the graph's size and the
check run's launches. A variant that fails ends the sweep with its error
(the JAX tool records "FAIL: ..." and goes on; nothing is caught here).

    python -m sam_road_tpu_torch.tools.experiment_infer_batch [B ...] [--fused 1 0] [--device cpu]
"""

from __future__ import annotations

import argparse
import gc
import json

import numpy as np

from sam_road_tpu_torch.tools import bench


def variant(model, overrides: dict, img, batch: int, fused: bool, runs: int, device):
    """One batch size and encoder: (row, the last run's outputs)."""
    import torch

    engine = bench.make_engine(device, {**overrides, "INFER_BATCH_SIZE": batch,
                                        "FUSED_ENCODER": fused}, model)
    result, out = bench.run(engine, img, runs)
    d = result["detail"]
    row = dict(min_s=result["value"], median_s=d["median_s"], all_runs_s=d["all_runs_s"],
               timings=d["timings"], peak_mem_gib=d["peak_mem_gib"], nodes=d["nodes"],
               edges=d["edges"], launches=d["launches"])
    del engine
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return row, out


def main(batch_sizes=(16, 32, 64), device: str = "cuda", *, fused=(1, 0), runs: int = 3,
         model=None, overrides: dict | None = None, region: np.ndarray | None = None,
         seed: int = bench.SEED) -> dict:
    """Returns and prints {"B<b>_fused" / "B<b>_eager": row}. `model`,
    `overrides` (on top of the bench config) and `region` exist so that a
    test can run the tool small."""
    from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random

    dev = bench.require_device(device)
    overrides = dict(overrides or {})
    if model is None:
        model = init_random(SAMRoad.from_config(bench.bench_config(overrides)), seed)
    img = bench.make_region() if region is None else region
    results = {"device": bench.device_name(dev)}
    for f in fused:
        for B in batch_sizes:
            key = f"B{B}_{'fused' if f else 'eager'}"
            results[key], _ = variant(model, overrides, img, B, bool(f), runs, dev)
            print(f"# {key}: {json.dumps(results[key])}", flush=True)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch_sizes", type=int, nargs="*", default=[16, 32, 64])
    ap.add_argument("--fused", type=int, nargs="+", default=[1, 0], choices=(0, 1),
                    help="1: the fused encoder (K1-K4); 0: the eager one (K5)")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args()
    main(args.batch_sizes, args.device, fused=args.fused, runs=args.runs)
