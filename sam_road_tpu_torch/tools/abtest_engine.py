"""Paired same-process engine A/B on the bench region (counterpart of the
repository's tools/abtest_engine.py).

Host times move 20-35 % between processes and between calls, which
swallows a 0.1 s change of the host path when two variants run apart. This
tool builds two engines in one process on the same weights: A is the bench
config (tools/bench.py) plus an optional JSON override, B the bench config
plus a JSON override (e.g. '{"FUSED_ENCODER": false}' or
'{"INFER_BATCH_SIZE": 16}'). Both take the thresholds calibrated on A's
masks; each runs once at them; then they run in turns, B A B A ..., for
`reps` rounds, each timed by the host clock around `infer_one_img`. It
reports each engine's least and median seconds, the paired per-round
differences A - B and their median (the statistic that decides an A/B),
each engine's least phase 1, both graphs' sizes, and whether the two
engines' nodes, edges and masks are equal. The TPU tool's
speculative-phase-2 counters have no counterpart in the port.

    python -m sam_road_tpu_torch.tools.abtest_engine '<B json>' [reps] ['<A json>'] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np

from sam_road_tpu_torch.tools import bench


def main(overrides_b: dict, reps: int = 5, overrides_a: dict | None = None,
         device: str = "cuda", *, model=None, base: dict | None = None,
         region: np.ndarray | None = None, seed: int = bench.SEED) -> dict:
    """Returns and prints the A/B. `model` (A's weights), `base` (on top of
    the bench config, under both overrides) and `region` exist so that a
    test can run the tool small."""
    from sam_road_tpu_torch.models.sam_road import SAMRoad

    dev = bench.require_device(device)
    overrides_a = overrides_a or {}
    eng_a = bench.make_engine(dev, {**(base or {}), **overrides_a}, model, seed)
    # B's model is built from B's config (its switches), with A's weights
    cfg_b = bench.bench_config({**(base or {}), **overrides_b})
    model_b = SAMRoad.from_config(cfg_b)
    model_b.load_state_dict(eng_a.model.state_dict())
    eng_b = bench.make_engine(dev, {**(base or {}), **overrides_b}, model_b)
    img = bench.make_region() if region is None else region

    bench.calibrate(eng_a, img, eng_b)
    graphs = {"a": eng_a.infer_one_img(img), "b": eng_b.infer_one_img(img)}
    print(f"# A nodes/edges {graphs['a'][0].shape[0]}/{graphs['a'][1].shape[0]}  "
          f"B {graphs['b'][0].shape[0]}/{graphs['b'][1].shape[0]}", flush=True)

    t_a, t_b, ph_a, ph_b = [], [], [], []
    for r in range(reps):
        for name, eng, ts, phs in (("B", eng_b, t_b, ph_b), ("A", eng_a, t_a, ph_a)):
            t = time.perf_counter()
            eng.infer_one_img(img)
            ts.append(time.perf_counter() - t)
            phs.append(dict(eng.last_timings))
            print(f"# round {r} {name}: {ts[-1]:.3f} s phase1 {phs[-1]['phase1']:.3f}",
                  flush=True)
    deltas = [a - b for a, b in zip(t_a, t_b)]
    out = {
        "device": bench.device_name(dev), "overrides": overrides_b, "overrides_a": overrides_a,
        "a_s": t_a, "b_s": t_b, "a_min": min(t_a), "b_min": min(t_b),
        "a_median": statistics.median(t_a), "b_median": statistics.median(t_b),
        "paired_delta_a_minus_b": deltas, "paired_delta_median": statistics.median(deltas),
        "a_phase1_min": min(p["phase1"] for p in ph_a),
        "b_phase1_min": min(p["phase1"] for p in ph_b),
        "a_timings": ph_a, "b_timings": ph_b,
        "a_graph": [int(graphs["a"][0].shape[0]), int(graphs["a"][1].shape[0])],
        "b_graph": [int(graphs["b"][0].shape[0]), int(graphs["b"][1].shape[0])],
        "same_outputs": all(np.array_equal(x, y) for x, y in zip(graphs["a"], graphs["b"])),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("b", nargs="?", default="{}", help="B's overrides, JSON")
    ap.add_argument("reps", nargs="?", type=int, default=5)
    ap.add_argument("a", nargs="?", default="{}", help="A's overrides, JSON")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args()
    main(json.loads(args.b), args.reps, json.loads(args.a), args.device)
