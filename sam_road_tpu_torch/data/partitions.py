"""The overlapping patch-grid planner (counterpart of
sam_road_tpu/data/partitions.py:get_patch_info_one_img)."""

from __future__ import annotations

import numpy as np


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
