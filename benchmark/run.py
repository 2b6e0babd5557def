"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration file, its traffic mix and its metrics are read
from BENCHMARK.json by name (benchmark/README.md). Set-up builds the
program from the configuration and the seed's weights and warms every
shape of the traffic; the window then measures for --seconds; with
--trace 1 a short traced segment follows it and the per-layer metrics are
reported instead of the end-to-end ones. Once the window has closed and the
program's state is freed, the plain reference checks what the window
produced. The last line of standard output is one JSON object; the
numbers compared and their limits end standard error.

Exits 2, printing no result, where no CUDA card (or fewer than the cell
asks for) is present, or where jax, jaxlib, flax or the JAX package is
loaded in this process after the window.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "sam_road_tpu")
GIB = 2 ** 30


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def read_json(path: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, path)) as f:
        return json.load(f)


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is a forbidden one."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def reader(name: str):
    """The per-layer metric's reader, benchmark/metrics/<name>.py::read."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(spec: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics (trace 0) or per-layer metrics
    (trace 1), as their BENCHMARK.json entries."""
    if not trace:
        return [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    reported = {m["name"] for m in metrics_of(spec, cell, False)}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell]) and m["moves"] in reported]


def end_to_end(name: str, run: dict):
    """The end-to-end metrics, all by the host's clock: region_s and
    train_step_s are the window's seconds over the units it completed,
    peak_mem_gib the window's allocator peak."""
    if name == "setup_s":
        return run["setup_s"]
    if name in ("region_s", "train_step_s"):
        return run["window_s"] / run["units"]
    if name == "peak_mem_gib":
        return run["peak_window"] / GIB
    raise KeyError(name)


def card(device) -> dict:
    import torch

    out = {"kind": torch.cuda.get_device_name(device)}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader", f"--id={torch.device(device).index or 0}"],
                           capture_output=True, text=True, timeout=30)
        out["nvidia_smi"] = q.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out["nvidia_smi"] = f"unread: {e}"
    return out


def execute(spec: dict, cell: str, seed: int, seconds: float, trace: bool, device,
            t_start: float = T_START, root: str = ROOT, limits: dict | None = None) -> tuple:
    """Run the cell on `device` (the check for a card is the caller's), its
    files read under `root`, its limits those of benchmark/limits/ unless
    given. Returns (result object, [[number, value, limit]], every number
    that the check computed)."""
    from benchmark import cells, correct

    work = next(w for w in spec["workloads"] if w["name"] == cell)
    config = next(c for c in spec["configs"] if c["name"] == work["config"])
    config_file = read_json(config["file"], root)
    mix = read_json(os.path.join("benchmark", "traffic", f"{work['traffic']}.json"), root)
    runner = {"region": cells.region, "train": cells.train}[mix["kind"]]
    run = runner(config_file, mix, seed, seconds, trace, device, t_start)

    metrics = {}
    for m in metrics_of(spec, cell, trace):
        value = end_to_end(m["name"], run) if not trace else reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    import torch

    sd = cells.ref_model.make_weights(run["arch"], run["weights_seed"], device)
    if run["kind"] == "region":
        numbers = correct.region_numbers(sd, run["arch"], run["cfg"], run["mix"], run["regions"],
                                         cells.distinct_outputs(run), run["calibration"],
                                         run["thresholds"], device)
    else:
        numbers = correct.train_numbers(sd, run["arch"], run["cfg"], run["batches"],
                                        run["program"], device)
    attempted = run["units"]
    ok, rows = correct.verdict(numbers, correct.limits_of(cell) if limits is None else limits)
    dev = {"platform": "gpu" if torch.device(device).type == "cuda" else torch.device(device).type,
           "kind": card(device)["kind"] if torch.device(device).type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(run["peak"])}
    result = {"correct": ok, "attempted": attempted, "failed": 0 if ok else attempted,
              "metrics": metrics, "device": dev}
    if trace and run["trace"] is not None:
        t = run["trace"]
        dev.update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": [[n, s] for n, s in t["device_ops"]],
                               "idle_gaps": t["idle_gaps"]}
    if run["kind"] == "region":
        result["work"] = {"regions": run["units"], "vertices_per_region": float(np.mean(
            [len(o[0]) for o in run["outputs"]])), "edges_per_region": float(np.mean(
                [len(o[1]) for o in run["outputs"]]))}
    else:
        result["work"] = {"steps": run["units"]}
    result["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return result, rows, numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec()
    work = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if work is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(work["chips"]):
        print(f"{args.workload} needs {work['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    info = card("cuda:0")
    print(f"card: {info['nvidia_smi']}", file=sys.stderr, flush=True)
    result, rows, _ = execute(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda:0"))
    found = forbidden_modules()  # what the process loaded, the window included
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 2
    for name, value, limit in rows:
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
