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
each engine's least phase 1, both graphs' sizes, whether the two
engines' nodes, edges and masks are equal, and, as the JAX tool does, the
speculative phase 2's counters of B's last round (`b_spec_last`:
spec_dispatched, spec_hits, spec_miss and the other spec_* keys, where B
speculates), with the device aggregation's last region (`b_agg_last`:
vertices, E, E_pad and the path taken, where B aggregates on the device).
`thresholds` skips the calibration and sets them on both engines;
`warm=False` skips the warm runs, for a caller whose process has run the
same path already, and compares the outputs of the last round. `arms`
runs several arms B against one A: each round every arm, then A once.

    python -m sam_road_tpu_torch.tools.abtest_engine '<B json>' [reps] ['<A json>'] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np

from sam_road_tpu_torch.tools import bench


def arms(overrides_b: dict, reps: int = 5, overrides_a: dict | None = None,
         device: str = "cuda", *, model=None, base: dict | None = None,
         region: np.ndarray | None = None, seed: int = bench.SEED,
         thresholds: dict | None = None, warm: bool = True) -> dict:
    """main's A/B with several arms B at once: `overrides_b` maps each
    arm's name to its overrides. Each round runs every arm in turn, then A
    once, and each arm's paired differences take that round's A. Returns
    and prints main's result for each arm, by name."""
    from sam_road_tpu_torch.models.sam_road import SAMRoad

    dev = bench.require_device(device)
    overrides_a = overrides_a or {}
    eng_a = bench.make_engine(dev, {**(base or {}), **overrides_a}, model, seed)
    engines = {}
    for name, over in overrides_b.items():
        # B's model is built from B's config (its switches), with A's weights
        model_b = SAMRoad.from_config(bench.bench_config({**(base or {}), **over}))
        model_b.load_state_dict(eng_a.model.state_dict())
        engines[name] = bench.make_engine(dev, {**(base or {}), **over}, model_b)
    img = bench.make_region() if region is None else region

    if thresholds is None:
        bench.calibrate(eng_a, img, *engines.values())
    else:
        for eng in (eng_a, *engines.values()):
            eng.config.update(thresholds)
    runs = [*engines.items(), ("A", eng_a)]
    secs = {name: [] for name, _ in runs}
    timings = {name: [] for name, _ in runs}
    graphs = {name: eng.infer_one_img(img) for name, eng in runs} if warm else {}
    for r in range(reps):
        for name, eng in runs:
            t = time.perf_counter()
            got = eng.infer_one_img(img)
            secs[name].append(time.perf_counter() - t)
            timings[name].append(dict(eng.last_timings))
            if not warm:
                graphs[name] = got
            print(f"# round {r} {name}: {secs[name][-1]:.3f} s phase1 "
                  f"{timings[name][-1]['phase1']:.3f}", flush=True)
    t_a, ph_a, ga = secs["A"], timings["A"], graphs["A"]
    out = {}
    for name, eng_b in engines.items():
        t_b, ph_b, gb = secs[name], timings[name], graphs[name]
        print(f"# A nodes/edges {ga[0].shape[0]}/{ga[1].shape[0]}  "
              f"{name} {gb[0].shape[0]}/{gb[1].shape[0]}", flush=True)
        deltas = [a - b for a, b in zip(t_a, t_b)]
        res = {
            "device": bench.device_name(dev), "overrides": overrides_b[name],
            "overrides_a": overrides_a,
            "a_s": t_a, "b_s": t_b, "a_min": min(t_a), "b_min": min(t_b),
            "a_median": statistics.median(t_a), "b_median": statistics.median(t_b),
            "paired_delta_a_minus_b": deltas, "paired_delta_median": statistics.median(deltas),
            "a_phase1_min": min(p["phase1"] for p in ph_a),
            "b_phase1_min": min(p["phase1"] for p in ph_b),
            "a_timings": ph_a, "b_timings": ph_b,
            "a_graph": [int(ga[0].shape[0]), int(ga[1].shape[0])],
            "b_graph": [int(gb[0].shape[0]), int(gb[1].shape[0])],
            "same_outputs": all(np.array_equal(x, y) for x, y in zip(ga, gb)),
        }
        spec_b = {k: v for k, v in ph_b[-1].items() if k.startswith("spec")}
        if spec_b:
            res["b_spec_last"] = spec_b
        if eng_b.last_agg is not None:
            res["b_agg_last"] = eng_b.last_agg
        print(json.dumps(res), flush=True)
        out[name] = res
    return out


def main(overrides_b: dict, reps: int = 5, overrides_a: dict | None = None,
         device: str = "cuda", **kw) -> dict:
    """Returns and prints the A/B. The keywords (`model`, A's weights;
    `base`, on top of the bench config, under both overrides; `region`;
    `seed`; `thresholds`; `warm`) are arms'; the first three exist so that
    a test can run the tool small."""
    return arms({"B": overrides_b}, reps, overrides_a, device, **kw)["B"]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("b", nargs="?", default="{}", help="B's overrides, JSON")
    ap.add_argument("reps", nargs="?", type=int, default=5)
    ap.add_argument("a", nargs="?", default="{}", help="A's overrides, JSON")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args()
    main(json.loads(args.b), args.reps, json.loads(args.a), args.device)
