"""Dataset partitions and the overlapping patch-grid planner (counterpart of
sam_road_tpu/data/partitions.py)."""

from __future__ import annotations

import json

import numpy as np


def cityscale_data_partition():
    """The index-mod split of the 180 Cityscale tiles: (train, validation,
    test) index lists."""
    train, test, validation = [], [], []
    for x in range(180):
        if x % 10 < 8:
            train.append(x)
        if x % 10 == 9:
            test.append(x)
        if x % 20 == 18:
            validation.append(x)
        if x % 20 == 8:
            test.append(x)
    return train, validation, test


def spacenet_data_partition(split_json_path: str = "./spacenet/data_split.json"):
    """The named (train, validation, test) tile lists of a SpaceNet split
    file."""
    with open(split_json_path) as f:
        data_list = json.load(f)
    return data_list["train"], data_list["validation"], data_list["test"]


def get_patch_info_one_img(
    image_index, image_size, sample_margin, patch_size, patches_per_edge
):
    """Evenly spaced overlapping patch grid for one square tile. Returns a
    list of (image_index, (x0, y0), (x1, y1)), x-major like the reference."""
    sample_max = image_size - (patch_size + sample_margin)
    eval_samples = np.linspace(start=sample_margin, stop=sample_max,
                               num=patches_per_edge)
    eval_samples = [round(x) for x in eval_samples]
    return [
        (image_index, (x, y), (x + patch_size, y + patch_size))
        for x in eval_samples
        for y in eval_samples
    ]
