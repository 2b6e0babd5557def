"""GraphLabelGenerator: per-patch topology labels for training (counterpart
of sam_road_tpu/data/graph_labels.py, line for line, over the port's graph
library and native NMS).

Per tile: subdivide the GT graph at 4 px, exclude the neighbourhoods of
crossover (overpass) points from keypoint candidacy, keep intersections
through NMS, oversample the regions around intersections and crossovers,
and label candidate pairs by bounded BFS connectivity on the subdivided
graph. The same np.random.Generator draws give the same labels as the JAX
package.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from sam_road_tpu_torch.graph.geometry import find_crossover_points
from sam_road_tpu_torch.graph.nms import nms_points
from sam_road_tpu_torch.graph.spatial import PointGridIndex
from sam_road_tpu_torch.graph.structure import (
    bfs_with_conditions,
    graph_from_adj_dict,
    subdivide_graph,
)


class GraphLabelGenerator:
    def __init__(self, config, full_graph: dict, coord_transform):
        """full_graph: sat2graph adjacency dict; coord_transform: [N, 2] ->
        [N, 2] into image (x, y)."""
        self.config = config
        self.full_graph_origin = graph_from_adj_dict(full_graph, coord_transform)
        self.crossover_points = find_crossover_points(self.full_graph_origin)
        self.subdivide_resolution = 4
        self.full_graph_subdivide = subdivide_graph(self.full_graph_origin,
                                                    self.subdivide_resolution)
        self.subdivide_points = np.asarray(self.full_graph_subdivide.points)
        self.graph_index = PointGridIndex(
            self.subdivide_points, cell_size=max(float(config.ROAD_NMS_RADIUS), 1.0))
        self.graph_kdtree = cKDTree(self.subdivide_points)

        # points near crossovers are never keypoint candidates
        exclude_indices = set()
        for p in self.crossover_points:
            exclude_indices.update(self.graph_kdtree.query_ball_point(np.asarray(p), 4))
        self.exclude_indices = exclude_indices

        # intersections always survive NMS (scores above 1 are immune)
        degrees = self.full_graph_subdivide.degree()
        itsc_indices = np.nonzero(degrees != 2)[0]
        point_num = self.subdivide_points.shape[0]
        self.nms_score_override = np.zeros((point_num,), dtype=np.float32)
        if itsc_indices.size:
            self.nms_score_override[itsc_indices] = 2.0

        # oversample near intersections and crossovers
        interesting_indices = set()
        interesting_radius = 32
        for i in itsc_indices:
            interesting_indices.update(self.graph_kdtree.query_ball_point(
                self.subdivide_points[i], interesting_radius))
        for p in self.crossover_points:
            interesting_indices.update(
                self.graph_kdtree.query_ball_point(np.asarray(p), interesting_radius))
        self.sample_weights = np.full((point_num,), 0.1, dtype=np.float32)
        if interesting_indices:
            self.sample_weights[list(interesting_indices)] = 0.9

    def sample_patch(self, patch, rot_index: int = 0, rng: np.random.Generator | None = None):
        """(points, samples) for one patch ((x0, y0), (x1, y1)): the NMS'd
        graph points [N, 2] in patch coordinates (rotated rot_index x 90
        degrees about the patch centre and jittered), and TOPO_SAMPLE_NUM
        samples (pairs [(src, tgt)...], shall_connect [bool...], valid
        [bool...]) of MAX_NEIGHBOR_QUERIES each."""
        if rng is None:
            rng = np.random.default_rng()
        cfg = self.config
        (x0, y0), (x1, y1) = patch
        query_box = (min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1))
        patch_indices = set(self.graph_index.query_box(query_box).tolist()) - self.exclude_indices

        sample_num = cfg.TOPO_SAMPLE_NUM
        max_nbr_queries = cfg.MAX_NEIGHBOR_QUERIES
        patch_indices = np.array(sorted(patch_indices), dtype=np.int64)
        if len(patch_indices) == 0:  # an empty patch gets null labels
            fake_sample = ([(0, 0)] * max_nbr_queries, [False] * max_nbr_queries,
                           [False] * max_nbr_queries)
            return np.array([[0.0, 0.0]], dtype=np.float32), [fake_sample] * sample_num

        patch_points = self.subdivide_points[patch_indices, :]

        # random scores emulate inference-time spacing; overrides keep
        # intersections
        nms_scores = rng.uniform(low=0.9, high=1.0, size=patch_indices.shape[0])
        nms_scores = np.maximum(nms_scores, self.nms_score_override[patch_indices])
        nmsed_points, kept_indices = nms_points(
            patch_points, nms_scores, radius=cfg.ROAD_NMS_RADIUS, return_indices=True)
        nmsed_indices = patch_indices[kept_indices]
        nmsed_point_num = nmsed_points.shape[0]

        sample_weights = self.sample_weights[nmsed_indices]
        sample_indices_in_nmsed = rng.choice(
            np.arange(nmsed_point_num, dtype=np.int32), size=sample_num, replace=True,
            p=sample_weights / np.sum(sample_weights))
        sample_indices = nmsed_indices[sample_indices_in_nmsed]

        radius = cfg.NEIGHBOR_RADIUS
        nmsed_kdtree = cKDTree(nmsed_points)
        sampled_points = self.subdivide_points[sample_indices, :]
        k = min(max_nbr_queries + 1, max(nmsed_point_num, 2))
        _, knn_idx = nmsed_kdtree.query(sampled_points, k=k, distance_upper_bound=radius)
        if knn_idx.ndim == 1:
            knn_idx = knn_idx[:, None]

        # sources repeat (weighted draws with replacement) and the BFS is
        # deterministic per source: build each unique source's sample once
        samples = []
        bfs_depth = radius // self.subdivide_resolution
        cache: dict = {}
        for i in range(sample_num):
            source_nmsed_idx = int(sample_indices_in_nmsed[i])
            if source_nmsed_idx in cache:
                samples.append(cache[source_nmsed_idx])
                continue
            source_node = int(sample_indices[i])
            valid_nbr = knn_idx[i, knn_idx[i, :] < nmsed_point_num][1:]  # nearest is self
            target_nodes = [int(nmsed_indices[ni]) for ni in valid_nbr]
            reached = bfs_with_conditions(self.full_graph_subdivide, source_node,
                                          set(target_nodes), bfs_depth)
            shall_connect = [t in reached for t in target_nodes]
            pairs = [(source_nmsed_idx, int(t)) for t in valid_nbr]
            valid = [True] * len(pairs)
            for _ in range(len(pairs), max_nbr_queries):
                pairs.append((source_nmsed_idx, source_nmsed_idx))
                shall_connect.append(False)
                valid.append(False)
            sample = (pairs, shall_connect, valid)
            cache[source_nmsed_idx] = sample
            samples.append(sample)

        # rotate about the patch centre by rot_index x 90 degrees CCW, then
        # jitter
        pts = nmsed_points - np.array([x0, y0], dtype=np.float64)[None, :]
        c = 0.5 * cfg.PATCH_SIZE
        for _ in range(rot_index % 4):
            pts = np.stack([pts[:, 1] - c, -(pts[:, 0] - c)], axis=1) + c  # (x, y) -> (y, -x)
        pts = pts + rng.normal(0.0, 1.0, size=pts.shape)
        return pts, samples
