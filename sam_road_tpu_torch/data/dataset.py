"""Batch collation (counterpart of sam_road_tpu/data/dataset.py's
collate_batch). The dataset, label generation and loader are not ported
yet: the trainer takes batches in this format."""

from __future__ import annotations

import numpy as np


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
