"""Mask -> graph extraction (counterpart of sam_road_tpu/graph/extraction.py).

extract_graph_points is the production path: threshold the fused keypoint
and road masks, NMS each, then union them with keypoint priority and NMS
once more. The A* extraction below it is the legacy alternative the JAX
package keeps for the reference's API (reference: graph_extraction.py:72-167),
a heapq A* in place of tcod; its discs are utils/viz.py's draw_disks, the
pixels cv2.circle sets.
"""

from __future__ import annotations

import heapq

import numpy as np

from sam_road_tpu_torch.graph.nms import nms_points
from sam_road_tpu_torch.utils.profiling import span
from sam_road_tpu_torch.utils.viz import draw_disks


def get_points_and_scores_from_mask(mask, threshold):
    """(x, y) coordinates and scores of the pixels above threshold."""
    above = mask > threshold
    xys = np.column_stack(np.where(above))[:, ::-1]
    return xys, mask[above]


def extract_graph_points(keypoint_mask, road_mask, config):
    """Fused uint8 masks -> NMS'd vertex set [N, 2] (x, y): keypoint and
    road candidates are thresholded and NMS'd separately, then unioned with
    keypoint priority and NMS'd once more. Spans (utils/profiling.py):
    extract.threshold, extract.nms_keypoint, extract.nms_road,
    extract.nms_final."""
    with span("extract.threshold"):
        kp_xy, kp_scores = get_points_and_scores_from_mask(
            keypoint_mask, config.ITSC_THRESHOLD * 255)
        road_xy, road_scores = get_points_and_scores_from_mask(
            road_mask, config.ROAD_THRESHOLD * 255)
    with span("extract.nms_keypoint"):
        kps_0 = nms_points(kp_xy, kp_scores, config.ITSC_NMS_RADIUS)
    with span("extract.nms_road"):
        kps_1 = nms_points(road_xy, road_scores, config.ROAD_NMS_RADIUS)
    with span("extract.nms_final"):
        candidates = np.concatenate([kps_0, kps_1], axis=0)
        priority = np.concatenate(
            [np.ones((kps_0.shape[0],)), np.zeros((kps_1.shape[0],))], axis=0)
        return nms_points(candidates, priority, config.ROAD_NMS_RADIUS)


# ---------------- legacy A* extraction ----------------

_SQRT2 = 1.4142135623730951


def _int_points(points):
    """[N, 2] (x, y) points truncated toward zero, as int() does."""
    return np.asarray(points, dtype=np.float64).reshape(-1, 2).astype(np.int64)


def astar_path_length(cost, start, end, max_len: int):
    """8-connected A* path length on a cost grid (tcod semantics: cell value 0
    blocks, >0 is traversal cost; diagonal steps cost ~1.41x). Returns the
    number of steps, or 0 if unreachable / longer than max_len."""
    h, w = cost.shape
    (c0, r0), (c1, r1) = start, end

    def heuristic(r, c):
        dr, dc = abs(r - r1), abs(c - c1)
        return max(dr, dc) + (_SQRT2 - 1) * min(dr, dc)

    dist = {(r0, c0): 0.0}
    steps = {(r0, c0): 0}
    pq = [(heuristic(r0, c0), 0.0, (r0, c0))]
    visited = set()
    while pq:
        _, d, (r, c) = heapq.heappop(pq)
        if (r, c) in visited:
            continue
        visited.add((r, c))
        if (r, c) == (r1, c1):
            return steps[(r, c)] + 1  # node count, like tcod get_path + start
        if steps[(r, c)] >= max_len:
            continue
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                if dr == 0 and dc == 0:
                    continue
                nr, nc = r + dr, c + dc
                if not (0 <= nr < h and 0 <= nc < w):
                    continue
                cell = cost[nr, nc]
                if cell == 0:
                    continue
                step_cost = float(cell) * (_SQRT2 if dr and dc else 1.0)
                nd = d + step_cost
                if nd < dist.get((nr, nc), np.inf):
                    dist[(nr, nc)] = nd
                    steps[(nr, nc)] = steps[(r, c)] + 1
                    heapq.heappush(pq, (nd + heuristic(nr, nc), nd, (nr, nc)))
    return 0


def create_cost_field_astar(sample_pts, road_mask, block_threshold=200):
    """Cost field for A*: 0 blocks; keypoint discs are free corridors
    (reference: graph_extraction.py:116-127). road_mask is uint8."""
    cost_field = np.zeros(road_mask.shape, dtype=np.uint8)
    kp_block_radius = 6
    draw_disks(cost_field, _int_points(sample_pts), kp_block_radius, 255)
    cost_field = np.maximum(cost_field, 255 - road_mask)
    cost_field[cost_field == 0] = 1
    cost_field[cost_field > block_threshold] = 0
    return cost_field


def is_connected_astar(cost, start, end, max_path_len):
    """Open keypoint discs, test path, restore (reference:
    graph_extraction.py:89-104)."""
    kp_block_radius = 6
    start_i = (int(start[0]), int(start[1]))
    end_i = (int(end[0]), int(end[1]))
    draw_disks(cost, [start_i], kp_block_radius, 1)
    draw_disks(cost, [end_i], kp_block_radius, 1)
    path_len = astar_path_length(cost, start_i, end_i, max_path_len)
    connected = (path_len != 0) and (path_len < max_path_len)
    draw_disks(cost, [start_i], kp_block_radius, 0)
    draw_disks(cost, [end_i], kp_block_radius, 0)
    return connected


def extract_graph_astar(keypoint_mask, road_mask, config):
    """Legacy A*-based graph extraction (reference:
    graph_extraction.py:142-167). Returns an adjacency dict of
    (x, y)-keyed edges, like the reference's nx.Graph surface."""
    from scipy.spatial import cKDTree

    kps = extract_graph_points(keypoint_mask, road_mask, config)
    cost_field = create_cost_field_astar(kps, road_mask)
    tree = cKDTree(kps)
    edges = set()
    checked = set()
    for p in kps:
        neighbor_indices = tree.query_ball_point(p, r=config.NEIGHBOR_RADIUS)
        for n_idx in neighbor_indices:
            n = kps[n_idx]
            start = (int(p[0]), int(p[1]))
            end = (int(n[0]), int(n[1]))
            if start == end or (start, end) in checked:
                continue
            if is_connected_astar(
                cost_field, p, n, max_path_len=config.NEIGHBOR_RADIUS
            ):
                edges.add((min(start, end), max(start, end)))
            checked.add((start, end))
    adj = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, []).append(a)
    return adj


def create_cost_field(sample_pts, road_mask):
    """Cost field for the Bresenham connectivity check
    (reference: graph_extraction.py:107-114)."""
    cost_field = np.zeros(road_mask.shape, dtype=np.uint8)
    kp_block_radius = 4
    draw_disks(cost_field, _int_points(sample_pts), kp_block_radius, 255)
    return np.maximum(cost_field, 255 - road_mask)


def is_connected_bresenham(cost, start, end):
    """Max-cost test along the rasterized segment between two points
    (reference: graph_extraction.py:72-86)."""
    c0, r0 = int(start[0]), int(start[1])
    c1, r1 = int(end[0]), int(end[1])
    # integer line rasterization (skimage.draw.line equivalent)
    npts = max(abs(r1 - r0), abs(c1 - c0)) + 1
    rr = np.round(np.linspace(r0, r1, npts)).astype(int)
    cc = np.round(np.linspace(c0, c1, npts)).astype(int)
    kp_block_radius = 4
    draw_disks(cost, [(c0, r0)], kp_block_radius, 0)
    draw_disks(cost, [(c1, r1)], kp_block_radius, 0)
    max_cost = np.max(cost[rr, cc])
    draw_disks(cost, [(c0, r0)], kp_block_radius, 255)
    draw_disks(cost, [(c1, r1)], kp_block_radius, 255)
    return max_cost < 255
