"""Validation panels (counterpart of render_val_mask_panel and
save_val_visualizations in sam_road_tpu/utils/viz.py), written with
data/png.py. The graph-drawing functions there need line and circle
rasterisation and are not ported yet."""

from __future__ import annotations

import os

import numpy as np

from sam_road_tpu_torch.data.png import write_png


def render_val_mask_panel(rgb, gt_keypoint, gt_road, pred_keypoint, pred_road):
    """One validation sample as [rgb | GT masks | predicted masks], the
    masks as keypoint in red over road in green. rgb [H, W, 3] float
    0-255, masks [H, W] float 0-1; returns uint8 RGB [H, 3W + 16, 3]."""
    h, w = gt_road.shape

    def mask_img(kp, road):
        img = np.zeros((h, w, 3), np.float32)
        img[..., 1] = np.clip(road, 0, 1) * 255.0
        img[..., 0] = np.clip(kp, 0, 1) * 255.0
        return img

    sep = np.full((h, 8, 3), 255.0, np.float32)
    panel = np.concatenate([np.clip(rgb, 0, 255), sep, mask_img(gt_keypoint, gt_road), sep,
                            mask_img(pred_keypoint, pred_road)], axis=1)
    return panel.astype(np.uint8)


def _mask01(x):
    x = np.asarray(x)
    return x.astype(np.float32) / 255.0 if x.dtype == np.uint8 else x.astype(np.float32)


def save_val_visualizations(out_dir, epoch, batch, mask_scores, count=4):
    """Write up to `count` panels of a validation batch (collate_batch's
    format) and its mask scores [B, H, W, 2] as
    <out_dir>/val_epoch{epoch}_sample{i}.png; returns their paths."""
    os.makedirs(out_dir, exist_ok=True)
    scores = np.asarray(mask_scores, np.float32)
    paths = []
    for i in range(min(int(count), scores.shape[0])):
        panel = render_val_mask_panel(
            np.asarray(batch["rgb"][i], np.float32), _mask01(batch["keypoint_mask"][i]),
            _mask01(batch["road_mask"][i]), scores[i, ..., 0], scores[i, ..., 1])
        path = os.path.join(out_dir, f"val_epoch{epoch}_sample{i}.png")
        write_png(path, panel)
        paths.append(path)
    return paths
