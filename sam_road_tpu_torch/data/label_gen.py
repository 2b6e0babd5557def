"""Offline label masks (counterpart of sam_road_tpu/data/label_gen.py, after
the reference's cityscale/generate_labels.py and spacenet/generate_labels.py).

Each tile's ground-truth sat2graph pickle is rasterised into two uint8
masks under <root>/processed/: keypoint_mask_<tile>.png, a disc of radius
KEYPOINT_RADIUS at every node whose degree is not 2, and road_mask_<tile>.png,
every edge as a line of width ROAD_WIDTH. The drawing is utils/viz.py's,
pixel for pixel cv2's, so the masks decode to the JAX package's bytes; the
PNGs are written with data/png.py (the file bytes may differ by zlib).
SatMapDataset reads them at load time.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

from sam_road_tpu_torch.data.png import write_png
from sam_road_tpu_torch.utils.viz import draw_disks, draw_lines

KEYPOINT_RADIUS = 3
ROAD_WIDTH = 3
CITYSCALE_TILES = 180
CITYSCALE_SIZE = 2048
SPACENET_SIZE = 400


def _build_xy_graph(gt_graph: dict, transform):
    """sat2graph dict -> (degree per (x, y) node, undirected edge set): the
    nodes transformed to integer (x, y), each edge once whatever its
    direction in the dict, and the edges whose ends coincide after the
    transform skipped."""
    edges = set()
    deg = {}
    for n, neis in gt_graph.items():
        a = transform(n)
        for nei in neis:
            b = transform(nei)
            if a == b:
                continue
            key = (min(a, b), max(a, b))
            if key in edges:
                continue
            edges.add(key)
            deg[a] = deg.get(a, 0) + 1
            deg[b] = deg.get(b, 0) + 1
    return deg, edges


def rasterize_tile_masks(gt_graph: dict, image_size: int, transform):
    """(keypoint_mask, road_mask), uint8 [image_size, image_size] each, of
    one tile's graph under `transform` ((r, c) key -> integer (x, y))."""
    deg, edges = _build_xy_graph(gt_graph, transform)
    keypoint_mask = np.zeros((image_size, image_size), dtype=np.uint8)
    road_mask = np.zeros((image_size, image_size), dtype=np.uint8)
    keypoints = [node for node, d in deg.items() if d != 2]
    if keypoints:
        draw_disks(keypoint_mask, keypoints, KEYPOINT_RADIUS, 255)
    if edges:
        ends = np.array(list(edges), dtype=np.int64)  # [E, 2 ends, (x, y)]
        draw_lines(road_mask, ends[:, 0], ends[:, 1], 255, ROAD_WIDTH)
    return keypoint_mask, road_mask


def _write_masks(out: str, tile, gt_path: str, image_size: int, transform) -> None:
    with open(gt_path, "rb") as f:
        gt_graph = pickle.load(f)
    kp, road = rasterize_tile_masks(gt_graph, image_size, transform)
    write_png(os.path.join(out, f"keypoint_mask_{tile}.png"), kp)
    write_png(os.path.join(out, f"road_mask_{tile}.png"), road)


def generate_cityscale_labels(root: str = "./cityscale"):
    """Masks of every region_<i>_refine_gt_graph.p under <root>/20cities/
    for i < 180 (the missing ones skipped), 2048 px, (r, c) -> (x, y) =
    (c, r). Returns the tiles written."""
    out = os.path.join(root, "processed")
    os.makedirs(out, exist_ok=True)
    written = []
    for tile in range(CITYSCALE_TILES):
        path = os.path.join(root, "20cities", f"region_{tile}_refine_gt_graph.p")
        if os.path.exists(path):
            _write_masks(out, tile, path, CITYSCALE_SIZE, lambda n: (int(n[1]), int(n[0])))
            written.append(tile)
    return written


def generate_spacenet_labels(root: str = "./spacenet"):
    """Masks of every tile that <root>/data_split.json names (test, then
    validation, then train) and whose RGB_1.0_meter/<tile>__gt_graph.p
    exists, 400 px, (r, c) -> (x, y) = (c, 400 - r). Returns the tiles
    written."""
    out = os.path.join(root, "processed")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(root, "data_split.json")) as jf:
        data_list = json.load(jf)
    written = []
    for tile in data_list["test"] + data_list["validation"] + data_list["train"]:
        path = os.path.join(root, "RGB_1.0_meter", f"{tile}__gt_graph.p")
        if os.path.exists(path):
            _write_masks(out, tile, path, SPACENET_SIZE,
                         lambda n: (int(n[1]), SPACENET_SIZE - int(n[0])))
            written.append(tile)
    return written
