"""The streamed phase 1's device time against the whole-region path's, with
every transfer removed (counterpart of the repository's
tools/probe_band_overhead.py).

The bench region and every slab of the streamed plan are on the card before
anything is timed. Each round then runs, on the compute stream:
  whole      the whole-region path on the resident region
             (`engine._phase1_region`: every batch, fused and finalised);
  bands      each band of the plan (`_band_pixels`, `_stream_band`: its
             batches, the carried columns, its finalised chunk), the card
             synchronised after each: `per_band` the band's seconds,
             `bands_total` the loop's;
  bands_async  every band and finalisation dispatched, one synchronisation
             at the end: the device cost of the split;
  whole2     the whole path again, so drift between the two cancels;
and `overhead_async_vs_mean_whole` = bands_async - (whole + whole2) / 2.
Seconds are CUDA events on the compute stream around each span (host
seconds on the CPU). Each round also checks that the chained bands' masks
equal the whole path's bit for bit (`masks_equal`, both band runs).
Thresholds come from `bench.calibrate` (its warm run also warms the
streamed path).

    python -m sam_road_tpu_torch.tools.probe_band_overhead [--rounds 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from sam_road_tpu_torch.tools import bench
from sam_road_tpu_torch.tools.probe_stream_sched import stream_plan


def span(dev, fn):
    """(fn()'s result, its seconds on the compute stream: two CUDA events
    and a synchronise; the host clock on the CPU)."""
    import torch

    if dev.type != "cuda":
        t = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3


def main(device: str = "cuda", *, rounds: int = 4, model=None,
         overrides: dict | None = None, region: np.ndarray | None = None,
         seed: int = bench.SEED) -> list:
    """Prints one JSON line a round ({round, whole, whole2, bands_total,
    bands_async, per_band, overhead_async_vs_mean_whole, masks_equal}) and
    returns them. `model`, `overrides` (on top of the bench config) and
    `region` exist so that a test can run the tool small."""
    import torch

    from sam_road_tpu_torch.parallel.mesh import on_device

    dev = bench.require_device(device)
    engine = bench.make_engine(dev, overrides, model, seed)
    img = bench.make_region() if region is None else region
    infos, plan = stream_plan(engine, img.shape[0])
    W = img.shape[1]
    slab_lo = [0] + [b["e"] for b in plan[:-1]]
    ends = [plan[i + 1]["a"] for i in range(len(plan) - 1)] + [W]

    def band(slabs, i, prev):
        return engine._stream_band(engine._band_pixels(plan, slab_lo, slabs, i), plan[i],
                                   infos, prev, ends[i])

    def bands_async(slabs):
        prev, chunks = None, []
        for i in range(len(plan)):
            _, chunk, prev = band(slabs, i, prev)
            chunks.append(chunk)
        return chunks

    def bands_synced(slabs):
        prev, chunks, per = None, [], []
        for i in range(len(plan)):
            (_, chunk, prev), s = span(dev, lambda: band(slabs, i, prev))
            chunks.append(chunk)
            per.append(s)
        return chunks, per

    rows = []
    with torch.no_grad(), on_device(dev):
        bench.calibrate(engine, img)
        slabs = [engine.uploads.put(img[:, lo:b["e"]]) for lo, b in zip(slab_lo, plan)]
        for s in slabs:
            engine.uploads.wait(s)
        img_dev = torch.from_numpy(np.ascontiguousarray(img)).to(dev)
        engine._phase1_region(img_dev, infos)  # the whole path, warm
        bench.sync(dev)
        for r in range(rounds):
            (_, whole_masks), whole = span(dev, lambda: engine._phase1_region(img_dev, infos))
            (chunks, per_band), total = span(dev, lambda: bands_synced(slabs))
            async_chunks, t_async = span(dev, lambda: bands_async(slabs))
            _, whole2 = span(dev, lambda: engine._phase1_region(img_dev, infos))
            equal = all(torch.equal(torch.cat(c, dim=1), whole_masks)
                        for c in (chunks, async_chunks))
            row = {"round": r, "whole": whole, "whole2": whole2, "bands_total": total,
                   "bands_async": t_async, "per_band": per_band,
                   "overhead_async_vs_mean_whole": t_async - (whole + whole2) / 2,
                   "masks_equal": equal, "bands": [[b["a"], b["e"]] for b in plan]}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args()
    main(args.device, rounds=args.rounds)
