"""A synthetic SpaceNet-format dataset for the training feed tool: the
repository's tests/synthetic_data.py::make_spacenet_fixture and
make_grid_graph_rc, kept here so that the package never imports from
tests/ and needs no cv2 (the card's machine has none): the road strokes are
utils/viz.py::draw_lines (cv2.line's pixels), the tiles and masks
data/png.py::write_png, the masks data/label_gen.py's. The same tiles,
graphs, split and masks as the test fixture: pixels, pickles and the split
file byte-equal (the PNG encodings differ: cv2's libpng filters rows
adaptively, write_png does not)."""

from __future__ import annotations

import json
import os
import pickle

import numpy as np


def make_grid_graph_rc(image_size: int, spacing: int) -> dict:
    """Street-grid adjacency dict in the SpaceNet GT frame, where the image
    (x, y) of a key (a, b) is (b, image_size - a)."""
    adj = {}

    def add(xy1, xy2):
        k1, k2 = (image_size - xy1[1], xy1[0]), (image_size - xy2[1], xy2[0])
        adj.setdefault(k1, []).append(k2)
        adj.setdefault(k2, []).append(k1)

    lo, hi = spacing, image_size - spacing
    for x in range(lo, hi + 1, spacing):
        for y in range(lo, hi + 1, spacing):
            if x + spacing <= hi:
                add((x, y), (x + spacing, y))
            if y + spacing <= hi:
                add((x, y), (x, y + spacing))
    return adj


def make_spacenet_fixture(root: str, image_size: int = 400, n_train: int = 2, n_val: int = 1,
                          n_test: int = 1, spacing: int = 50) -> dict:
    """Tiles, GT graphs, the split file and label masks of a tiny
    SpaceNet-format dataset under root/spacenet. Returns the split."""
    from sam_road_tpu_torch.data.label_gen import generate_spacenet_labels, rasterize_tile_masks
    from sam_road_tpu_torch.data.png import write_png
    from sam_road_tpu_torch.utils.viz import draw_lines

    rgb_dir = os.path.join(root, "spacenet", "RGB_1.0_meter")
    os.makedirs(rgb_dir, exist_ok=True)
    names = [f"SYN_{i}" for i in range(n_train + n_val + n_test)]
    split = {"train": names[:n_train], "validation": names[n_train:n_train + n_val],
             "test": names[n_train + n_val:]}
    with open(os.path.join(root, "spacenet", "data_split.json"), "w") as f:
        json.dump(split, f)

    def to_xy(key):
        return int(key[1]), image_size - int(key[0])

    rng = np.random.default_rng(0)
    for name in names:
        adj = make_grid_graph_rc(image_size, spacing)
        with open(os.path.join(rgb_dir, f"{name}__gt_graph.p"), "wb") as f:
            pickle.dump(adj, f)
        # imagery correlated with the graph: noisy terrain with dark road
        # strokes at the GT edges, so that the masks are learnable
        img = rng.integers(80, 200, (image_size, image_size, 3), dtype=np.uint8)
        ends = [(to_xy(a), to_xy(b)) for a, neis in adj.items() for b in neis]
        if ends:
            ends = np.array(ends, np.int64)
            draw_lines(img, ends[:, 0], ends[:, 1], (40, 40, 45), 5)
        noise = rng.integers(-15, 15, img.shape, dtype=np.int16)
        img = np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)
        write_png(os.path.join(rgb_dir, f"{name}__rgb.png"), img)

    if image_size == 400:  # the label generator's own size
        generate_spacenet_labels(os.path.join(root, "spacenet"))
    else:
        out = os.path.join(root, "spacenet", "processed")
        os.makedirs(out, exist_ok=True)
        for name in names:
            with open(os.path.join(rgb_dir, f"{name}__gt_graph.p"), "rb") as f:
                adj = pickle.load(f)
            kp, road = rasterize_tile_masks(adj, image_size, to_xy)
            write_png(os.path.join(out, f"keypoint_mask_{name}.png"), kp)
            write_png(os.path.join(out, f"road_mask_{name}.png"), road)
    return split
