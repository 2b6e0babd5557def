"""Metric evaluation runner (counterpart of sam_road_tpu/metrics/runner.py;
reference: cityscale_metrics/eval_schedule.bash + apls.bash + topo.bash +
apls.py + topo.py).

Per run dir (containing graph/<tile>.p pickles): per-tile APLS (the native
C++ executable, or the Python scorer when the caller asks with
use_native=False) and TOPO, then aggregation into score/{apls,topo}.json
with the reference's statistics. Tiles are scored in worker processes that
a fork server starts: a fork of the caller would copy whatever threads or
device state it holds, and the server, started once per process with this
module imported, forks a worker in milliseconds where a spawned one takes
seconds to import scipy. Each job carries metrics._native.USE_NATIVE, since
a worker does not see the caller's setting.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import pickle
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from sam_road_tpu_torch.data.partitions import (
    cityscale_data_partition,
    spacenet_data_partition,
)
from sam_road_tpu_torch.metrics import _native
from sam_road_tpu_torch.metrics.apls import (
    apls_score,
    sat2graph_to_apls_json,
)
from sam_road_tpu_torch.metrics.apls_native import apls_score_files_native
from sam_road_tpu_torch.metrics.topo import topo_score_one_tile


def _tiles_and_gt(dataset: str, data_root: str):
    if dataset == "cityscale":
        _, _, tiles = cityscale_data_partition()
        gt_pattern = os.path.join(
            data_root, "cityscale/20cities/region_{}_graph_gt.pickle"
        )
    else:
        _, _, tiles = spacenet_data_partition(
            os.path.join(data_root, "spacenet/data_split.json")
        )
        gt_pattern = os.path.join(data_root, "spacenet/RGB_1.0_meter/{}__gt_graph.p")
    return tiles, gt_pattern


def _load(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def _pool(workers: int) -> ProcessPoolExecutor:
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    return ProcessPoolExecutor(max_workers=workers, mp_context=ctx)


def _apls_one_tile(args):
    (tile, gt_path, pred_path, results_dir, use_native, spacenet) = args
    t = time.perf_counter()
    gt_json = sat2graph_to_apls_json(_load(gt_path))
    prop_json = sat2graph_to_apls_json(_load(pred_path))
    out_txt = os.path.join(results_dir, f"{tile}.txt")
    if use_native:
        gt_tmp = os.path.join(results_dir, f"{tile}_gt.json")
        prop_tmp = os.path.join(results_dir, f"{tile}_prop.json")
        with open(gt_tmp, "w") as f:
            json.dump(gt_json, f)
        with open(prop_tmp, "w") as f:
            json.dump(prop_json, f)
        try:
            score = apls_score_files_native(gt_tmp, prop_tmp, out_txt, spacenet=spacenet)
        finally:
            os.remove(gt_tmp)
            os.remove(prop_tmp)
    else:
        score = apls_score(gt_json, prop_json, spacenet=spacenet)
        with open(out_txt, "w") as f:
            f.write("%f %f %f\n" % score)
    return tile, score[2], time.perf_counter() - t


def evaluate_apls(run_dir: str, dataset: str = "cityscale", data_root: str = ".",
                  use_native: bool = True, tiles=None, workers: int = 0):
    """Per-tile APLS -> results/apls/<tile>.txt -> score/apls.json
    (reference: apls.bash + apls.py; tiles scored in parallel processes).
    Prints each tile's score and the seconds its worker took."""
    spacenet = dataset == "spacenet"
    all_tiles, gt_pattern = _tiles_and_gt(dataset, data_root)
    tiles = tiles if tiles is not None else all_tiles
    results_dir = os.path.join(run_dir, "results", "apls")
    os.makedirs(results_dir, exist_ok=True)
    jobs = [
        (t, gt_pattern.format(t), os.path.join(run_dir, "graph", f"{t}.p"),
         results_dir, use_native, spacenet)
        for t in tiles
        if os.path.exists(os.path.join(run_dir, "graph", f"{t}.p"))
    ]
    workers = workers or min(len(jobs), max(1, (os.cpu_count() or 2) // 2))
    scores = []
    if jobs:
        with _pool(workers) as ex:
            for tile, m, seconds in ex.map(_apls_one_tile, jobs):
                print(f"APLS {tile}: {m:.4f} ({seconds:.3f} s)", flush=True)
                scores.append(m)
    score_dir = os.path.join(run_dir, "score")
    os.makedirs(score_dir, exist_ok=True)
    mean = float(np.mean(scores)) if scores else 0.0
    with open(os.path.join(score_dir, "apls.json"), "w") as jf:
        json.dump({"apls": scores, "final_APLS": mean}, jf)
    print("APLS", mean)
    return mean


def _topo_one_tile(args):
    (tile, gt_path, pred_path, results_dir, spacenet, use_native) = args
    _native.USE_NATIVE = use_native
    t = time.perf_counter()
    out_txt = os.path.join(results_dir, f"{tile}.txt")
    p, r, f = topo_score_one_tile(_load(gt_path), _load(pred_path), spacenet=spacenet,
                                  outputfile=out_txt)
    return tile, p, r, f, time.perf_counter() - t


def evaluate_topo(run_dir: str, dataset: str = "cityscale", data_root: str = ".",
                  tiles=None, workers: int = 0):
    """Per-tile TOPO -> results/topo/<tile>.txt -> score/topo.json
    (reference: topo.bash + topo/main.py + topo.py; tiles scored in parallel
    processes — the Python marble/hole walks are ~100 s/tile at city
    density). Prints each tile's scores and the seconds its worker took."""
    spacenet = dataset == "spacenet"
    all_tiles, gt_pattern = _tiles_and_gt(dataset, data_root)
    tiles = tiles if tiles is not None else all_tiles
    results_dir = os.path.join(run_dir, "results", "topo")
    os.makedirs(results_dir, exist_ok=True)
    jobs = [
        (t, gt_pattern.format(t), os.path.join(run_dir, "graph", f"{t}.p"),
         results_dir, spacenet, _native.USE_NATIVE)
        for t in tiles
        if os.path.exists(os.path.join(run_dir, "graph", f"{t}.p"))
    ]
    workers = workers or min(len(jobs), max(1, os.cpu_count() or 2))
    precision, recall, f1 = [], [], []
    if jobs:
        with _pool(workers) as ex:
            for tile, p, r, f, seconds in ex.map(_topo_one_tile, jobs):
                print(f"TOPO {tile}: P={p:.4f} R={r:.4f} F1={f:.4f} ({seconds:.3f} s)",
                      flush=True)
                precision.append(p)
                recall.append(r)
                f1.append(f)
    score_dir = os.path.join(run_dir, "score")
    os.makedirs(score_dir, exist_ok=True)
    out = {
        "mean topo": [
            float(np.mean(f1)) if f1 else 0.0,
            float(np.mean(precision)) if precision else 0.0,
            float(np.mean(recall)) if recall else 0.0,
        ],
        "prec": precision,
        "recall": recall,
        "f1": f1,
    }
    with open(os.path.join(score_dir, "topo.json"), "w") as jf:
        json.dump(out, jf)
    print("TOPO", out["mean topo"])
    return out["mean topo"][0]


def evaluate_run(run_dir: str, dataset: str = "cityscale", data_root: str = ".",
                 use_native: bool = True, tiles=None):
    """Full eval schedule for one run dir (reference: eval_schedule.bash)."""
    apls = evaluate_apls(run_dir, dataset, data_root, use_native, tiles)
    topo = evaluate_topo(run_dir, dataset, data_root, tiles)
    return {"apls": apls, "topo_f1": topo}
