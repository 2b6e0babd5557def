"""Mask -> graph-vertex extraction (counterpart of
sam_road_tpu/graph/extraction.py:extract_graph_points)."""

from __future__ import annotations

import numpy as np

from sam_road_tpu_torch.graph.nms import nms_points


def get_points_and_scores_from_mask(mask, threshold):
    """(x, y) coordinates and scores of the pixels above threshold."""
    above = mask > threshold
    xys = np.column_stack(np.where(above))[:, ::-1]
    return xys, mask[above]


def extract_graph_points(keypoint_mask, road_mask, config):
    """Fused uint8 masks -> NMS'd vertex set [N, 2] (x, y): keypoint and
    road candidates are thresholded and NMS'd separately, then unioned with
    keypoint priority and NMS'd once more."""
    kp_xy, kp_scores = get_points_and_scores_from_mask(
        keypoint_mask, config.ITSC_THRESHOLD * 255)
    kps_0 = nms_points(kp_xy, kp_scores, config.ITSC_NMS_RADIUS)
    road_xy, road_scores = get_points_and_scores_from_mask(
        road_mask, config.ROAD_THRESHOLD * 255)
    kps_1 = nms_points(road_xy, road_scores, config.ROAD_NMS_RADIUS)
    candidates = np.concatenate([kps_0, kps_1], axis=0)
    priority = np.concatenate(
        [np.ones((kps_0.shape[0],)), np.zeros((kps_1.shape[0],))], axis=0)
    return nms_points(candidates, priority, config.ROAD_NMS_RADIUS)
