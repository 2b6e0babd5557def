"""Readings that set a cell's limits (benchmark/limits/<cell>.json), at
the cell's own size, several seeds in one process:

  program   the program as the cell runs it, with a short window, compared
            with the plain reference: the lower readings;
  control   the reference computed in float8 (benchmark/reference/model.py's
            FP8: e4m3 with per-tensor scales for every tensor a model
            computing in that precision holds, e5m2 for gradients), one
            precision below the configuration's bfloat16, put in the
            program's place: the upper readings;
  half      (training) the reference on half of every batch, the mean
            taken over the rest, in the program's place: a planted fault.

    python3 -m benchmark.control --workload <cell> --what program,control --seeds 1,2,3
        [--seconds 2] [--out readings.jsonl]

Prints one JSON line per (what, seed) with every number, and appends it to
--out. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from benchmark import cells, correct, run as bench_run, traffic
from benchmark.reference import model, region as ref_region, train as ref_train

FP8 = model.Precision("fp8")


def region_control(config_file: dict, mix: dict, seed: int, device) -> dict:
    """The fp8 reference in the program's place: its masks, its thresholds
    by the calibration rule, its extraction and its phase 2 (each patch's
    scores in phase 2's int16 form), judged as the program's outputs are."""
    model.tf32_off()
    arch = cells.arch_of(config_file)
    cfg = dict(config_file["config"])
    regions = traffic.regions(mix, seed)
    sd = model.make_weights(arch, traffic.weights_seed(mix, seed), device)
    done = [ref_region.masks_and_features(sd, arch, img, cfg, device, FP8) for img in regions]
    calibration = (done[0][0][..., 0], done[0][0][..., 1])
    thr = ref_region.thresholds(done[0][0], mix["itsc_quantile"], mix["road_quantile"])
    run_cfg = {**cfg, **thr}
    outputs = []
    for r, (masks, feats, origins) in enumerate(done):
        verts = ref_region.extract_vertices(masks, run_cfg)
        patches = []
        ref_region.edge_scores(sd, arch, feats, origins, verts, run_cfg, device, FP8, patches)
        scored = [(s, t, np.round(v * 32767).astype(np.int64)) for s, t, v in patches]
        scores = correct.pair_scores(scored, len(verts))
        edges = np.array([k for k, v in scores.items() if v > cfg["TOPO_THRESHOLD"]],
                         np.int64).reshape(-1, 2)
        outputs.append((r, (verts[:, ::-1], edges, masks[..., 0], masks[..., 1]), scored))
    del done
    return correct.region_numbers(sd, arch, cfg, mix, regions, outputs, calibration, thr, device)


def train_planted(config_file: dict, mix: dict, seed: int, device, prec, half: bool) -> dict:
    """The reference (in `prec`, on half batches where `half`) in the
    program's place for the checked steps."""
    model.tf32_off()
    arch = cells.arch_of(config_file)
    cfg = dict(config_file["config"])
    batches = traffic.train_batches(mix, cfg, seed)[:int(mix["checked_steps"])]
    sd = model.make_weights(arch, seed, device)
    losses, g1, g1_norm, p3 = ref_train.steps(sd, arch, cfg, batches, device, prec, half)
    program = dict(losses=[x[0] for x in losses], grad_norm=g1_norm, skipped=0.0,
                   first_grad={k: v.cpu() for k, v in g1.items()},
                   params={k: v.cpu() for k, v in p3.items()})
    del g1, p3
    return correct.train_numbers(sd, arch, cfg, batches, program, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--what", default="program,control")
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="readings.jsonl")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    spec = bench_run.load_spec()
    work = next(w for w in spec["workloads"] if w["name"] == args.workload)
    config = next(c for c in spec["configs"] if c["name"] == work["config"])
    config_file = bench_run.read_json(config["file"])
    mix = bench_run.read_json(os.path.join("benchmark", "traffic", f"{work['traffic']}.json"))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    card = bench_run.card(device)["nvidia_smi"]
    for what in args.what.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            if what == "program":
                _, _, numbers = bench_run.execute(spec, args.workload, seed, args.seconds,
                                                  False, device, t_start=t)
            elif what == "control" and mix["kind"] == "region":
                numbers = region_control(config_file, mix, seed, device)
            elif what in ("control", "half") and mix["kind"] == "train":
                numbers = train_planted(config_file, mix, seed, device,
                                        FP8 if what == "control" else model.FP32, what == "half")
            else:
                raise SystemExit(f"no reading {what!r} for a {mix['kind']} cell")
            line = dict(workload=args.workload, what=what, seed=seed, numbers=numbers,
                        seconds=round(time.perf_counter() - t, 1), card=card)
            print(json.dumps(line), flush=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
            cells.free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
