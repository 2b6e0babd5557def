"""SatMapDataset, collate_batch and BatchLoader (counterpart of
sam_road_tpu/data/dataset.py): every tile in host memory, random training
patches with rot90 augmentation, the deterministic eval patch grid, and a
loader of producer threads.

Tiles and masks are read with data/png.py (the GPU machine has no cv2); the
same np.random.Generator draws give byte-equal samples and batches to the
JAX package's.
"""

from __future__ import annotations

import math
import os
import pickle
import queue
import threading

import numpy as np

from sam_road_tpu_torch.data.graph_labels import GraphLabelGenerator
from sam_road_tpu_torch.data.partitions import (
    cityscale_data_partition,
    get_patch_info_one_img,
    spacenet_data_partition,
)
from sam_road_tpu_torch.data.png import read_png


def read_rgb_img(path):
    """A tile as uint8 [H, W, 3] RGB (a grayscale PNG repeated into three
    channels), as cv2.imread + BGR -> RGB gives it."""
    img = read_png(path)
    return np.repeat(img[..., None], 3, axis=2) if img.ndim == 2 else img


def read_mask(path):
    """A label mask as uint8 [H, W]; it must be a grayscale PNG."""
    img = read_png(path)
    if img.ndim != 2:
        raise ValueError(f"{path}: a mask must be a grayscale PNG, got shape {img.shape}")
    return img


class SatMapDataset:
    """Every tile of one split (rgb, masks and a GraphLabelGenerator) in
    memory. cityscale: 2048 px tiles, margin 64; spacenet: 400 px, margin 0;
    config.IMAGE_SIZE overrides the tile size (synthetic fixtures). dev_run
    keeps the first 4 tiles."""

    def __init__(self, config, is_train: bool, dev_run: bool = False, data_root: str = "."):
        self.config = config
        if config.DATASET == "cityscale":
            self.IMAGE_SIZE = int(config.IMAGE_SIZE or 2048)
            self.SAMPLE_MARGIN = 64
            base = os.path.join(data_root, "cityscale")
            rgb_pattern = os.path.join(base, "20cities/region_{}_sat.png")
            keypoint_mask_pattern = os.path.join(base, "processed/keypoint_mask_{}.png")
            road_mask_pattern = os.path.join(base, "processed/road_mask_{}.png")
            gt_graph_pattern = os.path.join(base, "20cities/region_{}_refine_gt_graph.p")
            train, val, test = cityscale_data_partition()

            def coord_transform(v):  # (r, c) -> (x, y)
                return v[:, ::-1]
        elif config.DATASET == "spacenet":
            self.IMAGE_SIZE = int(config.IMAGE_SIZE or 400)
            self.SAMPLE_MARGIN = 0
            base = os.path.join(data_root, "spacenet")
            rgb_pattern = os.path.join(base, "RGB_1.0_meter/{}__rgb.png")
            keypoint_mask_pattern = os.path.join(base, "processed/keypoint_mask_{}.png")
            road_mask_pattern = os.path.join(base, "processed/road_mask_{}.png")
            gt_graph_pattern = os.path.join(base, "RGB_1.0_meter/{}__gt_graph.p")
            train, val, test = spacenet_data_partition(os.path.join(base, "data_split.json"))
            size = self.IMAGE_SIZE

            def coord_transform(v):  # the GT frame's (r?, c?) -> image (x, y)
                return np.stack([v[:, 1], size - v[:, 0]], axis=1)
        else:
            raise ValueError(f"unknown DATASET {config.DATASET!r}")

        self.is_train = is_train
        tile_indices = (train + val) if is_train else test
        if dev_run:
            tile_indices = tile_indices[:4]
        self.tile_indices = tile_indices

        self.rgbs, self.keypoint_masks, self.road_masks = [], [], []
        self.graph_label_generators = []
        for tile_idx in tile_indices:
            with open(gt_graph_pattern.format(tile_idx), "rb") as f:
                gt_graph_adj = pickle.load(f)
            if len(gt_graph_adj) == 0:
                print(f"===== skipped empty tile {tile_idx} =====")
                continue
            self.rgbs.append(read_rgb_img(rgb_pattern.format(tile_idx)))
            self.road_masks.append(read_mask(road_mask_pattern.format(tile_idx)))
            self.keypoint_masks.append(read_mask(keypoint_mask_pattern.format(tile_idx)))
            self.graph_label_generators.append(
                GraphLabelGenerator(config, gt_graph_adj, coord_transform))

        self.sample_min = self.SAMPLE_MARGIN
        self.sample_max = self.IMAGE_SIZE - (config.PATCH_SIZE + self.SAMPLE_MARGIN)

        if not is_train:
            per_edge = math.ceil((self.IMAGE_SIZE - 2 * self.SAMPLE_MARGIN) / config.PATCH_SIZE)
            self.eval_patches = []
            for i in range(len(self.rgbs)):
                self.eval_patches += get_patch_info_one_img(
                    i, self.IMAGE_SIZE, self.SAMPLE_MARGIN, config.PATCH_SIZE, per_edge)

    def __len__(self):
        if self.is_train:
            # a virtual epoch of about 17x the training pixels
            if self.config.DATASET == "cityscale":
                return max(1, int(self.IMAGE_SIZE / self.config.PATCH_SIZE)) ** 2 * 2500
            return 84667
        return len(self.eval_patches)

    def sample(self, idx: int, rng: np.random.Generator | None = None) -> dict:
        """One example as a dict of numpy arrays: a random patch and
        rotation (train) or eval patch `idx`, with its labels."""
        if rng is None:
            rng = np.random.default_rng()
        cfg = self.config
        if self.is_train:
            img_idx = int(rng.integers(0, len(self.rgbs)))
            begin_x = int(rng.integers(self.sample_min, self.sample_max + 1))
            begin_y = int(rng.integers(self.sample_min, self.sample_max + 1))
        else:
            img_idx, (begin_x, begin_y), _ = self.eval_patches[idx]
        end_x = begin_x + cfg.PATCH_SIZE
        end_y = begin_y + cfg.PATCH_SIZE

        rgb_patch = self.rgbs[img_idx][begin_y:end_y, begin_x:end_x, :]
        kp_patch = self.keypoint_masks[img_idx][begin_y:end_y, begin_x:end_x]
        road_patch = self.road_masks[img_idx][begin_y:end_y, begin_x:end_x]

        rot_index = 0
        if self.is_train:
            rot_index = int(rng.integers(0, 4))
            rgb_patch = np.rot90(rgb_patch, rot_index, (0, 1)).copy()
            kp_patch = np.rot90(kp_patch, rot_index, (0, 1)).copy()
            road_patch = np.rot90(road_patch, rot_index, (0, 1)).copy()

        graph_points, topo_samples = self.graph_label_generators[img_idx].sample_patch(
            ((begin_x, begin_y), (end_x, end_y)), rot_index, rng)
        pairs, connected, valid = zip(*topo_samples)
        return {
            "rgb": rgb_patch.astype(np.float32),
            "keypoint_mask": kp_patch.astype(np.float32) / 255.0,
            "road_mask": road_patch.astype(np.float32) / 255.0,
            "graph_points": np.asarray(graph_points, np.float32),
            "pairs": np.asarray(pairs, np.int32),
            "connected": np.asarray(connected, bool),
            "valid": np.asarray(valid, bool),
        }


def collate_batch(samples, point_bucket: int = 128) -> dict:
    """Stack samples into a batch: graph_points padded with zeros to the
    largest count rounded up to `point_bucket` (at least one bucket), rgb as
    uint8 and the masks as uint8 round(v * 255), an exact encoding of
    integer pixels and binary masks; the train and eval steps restore
    floats on the device (training/harness.py::materialize_batch)."""
    max_pts = max(s["graph_points"].shape[0] for s in samples)
    padded_len = max(point_bucket, -(-max_pts // point_bucket) * point_bucket)
    out = {}
    for key in samples[0]:
        if key == "graph_points":
            out[key] = np.stack([np.pad(s[key], ((0, padded_len - s[key].shape[0]), (0, 0)))
                                 for s in samples])
        elif key == "rgb":
            out[key] = np.stack([s[key] for s in samples]).astype(np.uint8)
        elif key in ("keypoint_mask", "road_mask"):
            out[key] = np.stack([np.round(s[key] * 255.0) for s in samples]).astype(np.uint8)
        else:
            out[key] = np.stack([s[key] for s in samples])
    return out


class BatchLoader:
    """Batches of a SatMapDataset from producer threads (label generation
    is numpy and scipy, which release the GIL for much of their time).

    Training: num_workers threads, each drawing from its own
    np.random.default_rng(seed + 7919 * process_index + 1000003 * worker).
    Evaluation: one producer over this process's strided share of the
    deterministic patch order (patches p, p + P, ...); a ragged last batch
    repeats the last patch at sample_weight 0. A producer that raises ends
    the iteration with its exception."""

    def __init__(self, dataset: SatMapDataset, batch_size: int, seed: int = 0,
                 point_bucket: int = 128, prefetch: int = 4,
                 num_batches: int | None = None, num_workers: int = 2,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed + 7919 * process_index
        self.point_bucket = point_bucket
        self.prefetch = prefetch
        self.num_workers = max(1, num_workers) if dataset.is_train else 1
        self.process_index = int(process_index)
        self.process_count = max(1, int(process_count))
        eval_share = len(range(self.process_index, len(dataset), self.process_count))
        if num_batches is None:
            if dataset.is_train:
                num_batches = len(dataset) // batch_size
            else:  # exactly this process's share, so processes stay disjoint
                num_batches = max(1, -(-eval_share // batch_size))
        self.num_batches = num_batches

    def __len__(self):
        return self.num_batches

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        batch_counter = iter(range(self.num_batches))
        counter_lock = threading.Lock()
        order = None
        if not self.dataset.is_train:
            order = np.arange(len(self.dataset))[self.process_index::self.process_count]

        def worker(wid: int):
            rng = np.random.default_rng(self.seed + 1000003 * wid)
            try:
                while not stop.is_set():
                    with counter_lock:
                        bi = next(batch_counter, None)
                    if bi is None:
                        q.put(None)
                        return
                    samples = []
                    weights = np.ones((self.batch_size,), np.float32)
                    for i in range(self.batch_size):
                        idx = 0
                        if order is not None:
                            g = bi * self.batch_size + i
                            if g < len(order):
                                idx = int(order[g])
                            else:  # ragged last batch: repeat the last patch, weight 0
                                idx = int(order[-1])
                                weights[i] = 0.0
                        samples.append(self.dataset.sample(idx, rng))
                    batch = collate_batch(samples, self.point_bucket)
                    if order is not None:
                        batch["sample_weight"] = weights
                    q.put(batch)
            except BaseException as e:  # handed to the consumer, which raises it
                q.put(e)

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        finished = produced = 0
        try:
            while finished < self.num_workers and produced < self.num_batches:
                batch = q.get()
                if batch is None:
                    finished += 1
                    continue
                if isinstance(batch, BaseException):
                    raise batch
                produced += 1
                yield batch
        finally:
            stop.set()
