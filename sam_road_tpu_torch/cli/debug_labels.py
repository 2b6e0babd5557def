"""Label debugger CLI (counterpart of sam_road_tpu/cli/debug_labels.py, with
the same flags and draws; reference: dataset.py:234-284,
test_graph_label_generator): renders sampled topology labels over rotated
RGB patches of one training tile to <out>/viz_<i>.png.

    python -m sam_road_tpu_torch.cli.debug_labels --config cfg.yaml [--data_root .]
        [--out debug] [--tile 0] [--num 16] [--seed 0]

For each of --num patches, drawn from np.random.default_rng(--seed) in the
JAX CLI's order (patch corner, rotation, GraphLabelGenerator.sample_patch,
a colour per sample): each valid pair's source as a disk of radius 4 and its
target of radius 2 in the sample's colour, and a one-pixel white line where
the pair is connected. The same seed writes the JAX CLI's pixels. Host work
only: there is no --device flag.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--data_root", default=".")
    parser.add_argument("--out", default="debug")
    parser.add_argument("--tile", type=int, default=0,
                        help="tile index within the train split")
    parser.add_argument("--num", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    from sam_road_tpu_torch.config import load_config
    from sam_road_tpu_torch.data.dataset import SatMapDataset
    from sam_road_tpu_torch.data.png import write_png
    from sam_road_tpu_torch.utils.viz import draw_disks, draw_lines

    config = load_config(args.config)
    ds = SatMapDataset(config, is_train=True, data_root=args.data_root)
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(args.seed)

    gen = ds.graph_label_generators[args.tile]
    rgb = ds.rgbs[args.tile]
    patch_size = int(config.PATCH_SIZE)
    lo, hi = ds.sample_min, ds.sample_max

    paths = []
    for i in range(args.num):
        x0 = int(rng.integers(lo, hi + 1))
        y0 = int(rng.integers(lo, hi + 1))
        rot_index = int(rng.integers(0, 4))
        patch = ((x0, y0), (x0 + patch_size, y0 + patch_size))
        points, samples = gen.sample_patch(patch, rot_index, rng)

        bgr_patch = rgb[y0:y0 + patch_size, x0:x0 + patch_size, ::-1]
        bgr_patch = np.rot90(bgr_patch, rot_index, (0, 1)).copy()
        for pairs, shall_connect, valid in samples:
            color = tuple(int(c) for c in rng.integers(0, 256, size=3))
            for (src, tgt), connected, is_valid in zip(pairs, shall_connect, valid):
                if not is_valid:
                    continue
                p0, p1 = points[src].astype(np.int32), points[tgt].astype(np.int32)
                draw_disks(bgr_patch, p0, 4, color)
                draw_disks(bgr_patch, p1, 2, color)
                if connected:
                    draw_lines(bgr_patch, p0, p1, (255, 255, 255), 1)
        path = os.path.join(args.out, f"viz_{i}.png")
        write_png(path, bgr_patch[..., ::-1])
        paths.append(path)
    print(f"wrote {args.num} label visualizations to {args.out}/")
    return paths


if __name__ == "__main__":
    main()
