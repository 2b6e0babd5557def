"""Triage CLI (counterpart of sam_road_tpu/cli/triage.py, with the same
flags and file names; reference: triage.py:84-111).

    python -m sam_road_tpu_torch.cli.triage [--results inference_results.pickle]
        [--output_dir triage/below_average] [--sample_num 200] [--smd_threshold 0.05]

Reads a pickled list of per-tile records (img_path, pred_nodes, pred_edges,
gt_nodes, gt_edges, smd), keeps those whose smd is above the threshold,
draws up to sample_num of them with Python's `random.sample` (seed it as the
JAX CLI's caller does, with random.seed), and writes each as a side-by-side
predicted | ground-truth overlay, smd_{smd:.6f}_{img_name}, worst first.
Host work only: there is no --device flag, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import os
import pickle
import random


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--results", default="inference_results.pickle")
    parser.add_argument("--output_dir", default="triage/below_average")
    parser.add_argument("--sample_num", type=int, default=200)
    parser.add_argument("--smd_threshold", type=float, default=0.05)
    args = parser.parse_args(argv)

    from sam_road_tpu_torch.data.png import write_png
    from sam_road_tpu_torch.utils.viz import visualize_pred_gt_pair

    with open(args.results, "rb") as f:
        inference_results = pickle.load(f)

    os.makedirs(args.output_dir, exist_ok=True)
    selected = [x for x in inference_results if x["smd"] > args.smd_threshold]
    sampled = random.sample(selected, min(args.sample_num, len(selected)))
    sampled = sorted(sampled, key=lambda x: -x["smd"])
    paths = []
    for x in sampled:
        pair_img = visualize_pred_gt_pair(x)  # BGR, as cv2.imwrite takes it
        img_name = os.path.basename(x["img_path"])
        path = os.path.join(args.output_dir, f"smd_{x['smd']:.6f}_{img_name}")
        write_png(path, pair_img[..., ::-1])
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
