"""Metric evaluation CLI (counterpart of sam_road_tpu/cli/evaluate.py, with
the same flags; reference: eval_schedule.bash / apls.bash / topo.bash as one
command).

    python -m sam_road_tpu_torch.cli.evaluate --run_dir save/<run> [save/<run2> ...]
        [--dataset cityscale|spacenet] [--data_root .] [--metric all|apls|topo]
        [--tiles 8,9,19] [--no_native]

Scores each run dir's graph/<tile>.p (what cli.infer writes) against the
dataset's ground truth: results/{apls,topo}/<tile>.txt and
score/{apls,topo}.json (metrics/runner.py). The metrics are host code
(numpy, scipy and the native C++ scorers) and do no device work, so there
is no --device flag, as in the JAX CLI: its absence is not a CPU default.
Nothing is compiled for a device either, so the JAX CLI's compilation cache
has no counterpart. --no_native scores APLS with the Python scorer; without
it a native build that fails raises.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--run_dir", required=True, nargs="+",
                        help="one or more run dirs containing graph/*.p")
    parser.add_argument("--dataset", default="cityscale",
                        choices=["cityscale", "spacenet"])
    parser.add_argument("--data_root", default=".")
    parser.add_argument("--metric", default="all", choices=["all", "apls", "topo"])
    parser.add_argument("--tiles", default=None,
                        help="comma-separated tile ids (default: test split)")
    parser.add_argument("--no_native", action="store_true",
                        help="score APLS with the Python scorer")
    args = parser.parse_args(argv)

    from sam_road_tpu_torch.metrics.runner import evaluate_apls, evaluate_topo

    tiles = None
    if args.tiles:
        raw = args.tiles.split(",")
        tiles = [int(t) if t.isdigit() else t for t in raw]

    for run_dir in args.run_dir:
        print(f"==== evaluating {run_dir} ====")
        if args.metric in ("all", "apls"):
            evaluate_apls(run_dir, args.dataset, args.data_root,
                          use_native=not args.no_native, tiles=tiles)
        if args.metric in ("all", "topo"):
            evaluate_topo(run_dir, args.dataset, args.data_root, tiles=tiles)


if __name__ == "__main__":
    main()
