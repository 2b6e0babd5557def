"""Threshold-calibration CLI (counterpart of sam_road_tpu/cli/test.py, with
the same flags, lines and JSON, plus --device).

    python -m sam_road_tpu_torch.cli.test --config configs/toponet_vitb_512_cityscale.yaml
        --checkpoint CKPT [--dev_run] [--data_root DIR] [--output_json PATH]
        [--device cuda|cpu]

Runs the evaluation patch grid of the config's validation split through
the model (training/harness.py::run_validation), accumulates the PR
histograms and prints the best-F1 threshold of each head: the numbers for
the ITSC / ROAD / TOPO_THRESHOLD config keys. --checkpoint is picked by
content as in cli/infer.py. --device cuda (the default) raises when torch
sees no GPU. Returns the thresholds.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True,
                        help="ckpt_epoch_N.pt, or a torch .ckpt / .pth")
    parser.add_argument("--dev_run", action="store_true")
    parser.add_argument("--data_root", default=".")
    parser.add_argument("--output_json", default=None)
    parser.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs an NVIDIA GPU and torch sees none; "
                           "pass --device cpu to run on the CPU")

    from sam_road_tpu_torch.config import load_config
    from sam_road_tpu_torch.data.dataset import BatchLoader, SatMapDataset
    from sam_road_tpu_torch.models.convert import load_weights
    from sam_road_tpu_torch.ops.metrics import find_best_threshold
    from sam_road_tpu_torch.training.harness import run_validation

    config = load_config(args.config)
    model, mismatched = load_weights(args.checkpoint, config)
    if mismatched:
        print(f"warning: {len(mismatched)} params not in checkpoint")
    model = model.to(device).eval()

    ds = SatMapDataset(config, is_train=False, dev_run=args.dev_run, data_root=args.data_root)
    batch_size = int(config.BATCH_SIZE)
    loader = BatchLoader(ds, batch_size, num_batches=max(1, len(ds) // batch_size))
    metrics = run_validation(config, model, loader)
    results = {}
    print("======= Finding best thresholds ======")
    for category, hists in metrics["_pr_histograms"].items():
        best = find_best_threshold(hists[0], hists[1])
        results[category] = best
        print(f"======= {category} ======")
        print(f"Best threshold {best['threshold']}, P={best['precision']} "
              f"R={best['recall']} F1={best['f1']}")
    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
