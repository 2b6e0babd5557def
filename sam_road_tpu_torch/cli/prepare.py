"""Offline label-mask preparation CLI (counterpart of
sam_road_tpu/cli/prepare.py, with the same flags and last line).

    python -m sam_road_tpu_torch.cli.prepare --dataset cityscale|spacenet [--data_root .]

rasterises each tile's ground-truth graph into keypoint and road mask PNGs
under <data_root>/<dataset>/processed/ (data/label_gen.py), which
SatMapDataset reads at load time. The masks are host work (numpy and a small
C++ rasteriser): there is no --device flag, as in the JAX CLI. Returns the
tiles written.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", required=True, choices=["cityscale", "spacenet"])
    parser.add_argument("--data_root", default=".")
    args = parser.parse_args(argv)

    from sam_road_tpu_torch.data.label_gen import (
        generate_cityscale_labels,
        generate_spacenet_labels,
    )

    root = os.path.join(args.data_root, args.dataset)
    generate = generate_cityscale_labels if args.dataset == "cityscale" else generate_spacenet_labels
    tiles = generate(root)
    out = os.path.join(root, "processed")
    n = len(os.listdir(out)) if os.path.isdir(out) else 0
    print(f"wrote {n} mask PNGs to {out}")
    return tiles


if __name__ == "__main__":
    main()
