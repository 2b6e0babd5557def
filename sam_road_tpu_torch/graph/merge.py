"""Large-map graph post-processing (counterpart of
sam_road_tpu/graph/merge.py, line for line; reference: graph_utils.py:273-380):
isolate removal, eps-clustering node merge, edge splitting at nearby nodes,
graph concatenation, and their composition merge_into_large_graph. The
clustering is union-find over a grid index (DBSCAN(min_samples=1)'s labels),
the split candidates come from the same grid index (where the reference used
shapely's STRtree).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from sam_road_tpu_torch.graph.geometry import point_segment_distance
from sam_road_tpu_torch.graph.spatial import PointGridIndex


def remove_isolate_nodes(nodes, edges):
    """Remove degree-0 nodes and reindex (reference: graph_utils.py:273-289)."""
    nodes = np.asarray(nodes)
    edges_arr = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    n = nodes.shape[0]
    degree = np.zeros(n, dtype=np.int64)
    if edges_arr.shape[0] > 0:
        np.add.at(degree, edges_arr[:, 0], 1)
        np.add.at(degree, edges_arr[:, 1], 1)
    keep = degree > 0
    keep_indices = np.where(keep)[0]
    old_to_new = np.full(n, -1, dtype=np.int64)
    old_to_new[keep_indices] = np.arange(keep_indices.shape[0])
    remaining_nodes = nodes[keep_indices]
    # Dedup undirected edges preserving first-seen orientation/order
    # (networkx Graph edge iteration semantics).
    seen = set()
    new_edges = []
    for s, t in edges_arr:
        key = (min(s, t), max(s, t))
        if key in seen:
            continue
        seen.add(key)
        new_edges.append((int(old_to_new[s]), int(old_to_new[t])))
    return remaining_nodes, new_edges


def _eps_cluster_labels(nodes: np.ndarray, eps: float) -> np.ndarray:
    """Connected components of the eps-neighbor graph; labels ordered by first
    occurrence (matches DBSCAN(eps, min_samples=1) labels)."""
    n = nodes.shape[0]
    parent = np.arange(n)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    index = PointGridIndex(nodes, cell_size=max(eps, 1e-9))
    for i in range(n):
        x, y = nodes[i]
        cand = index.query_box((x - eps, y - eps, x + eps, y + eps))
        d = np.linalg.norm(nodes[cand] - nodes[i], axis=1)
        for j in cand[d <= eps]:
            ri, rj = find(i), find(int(j))
            if ri != rj:
                parent[max(ri, rj)] = min(ri, rj)
    roots = np.array([find(i) for i in range(n)])
    labels = np.full(n, -1, dtype=np.int64)
    next_label = 0
    for i in range(n):
        if labels[i] == -1:
            r = roots[i]
            mask = roots == r
            labels[mask] = next_label
            next_label += 1
    return labels


def merge_nodes(nodes, edges, distance_threshold):
    """Cluster nodes within distance_threshold, replace by cluster centroids,
    remap edges dropping self-loops (reference: graph_utils.py:292-314)."""
    nodes = np.asarray(nodes, dtype=np.float64)
    labels = _eps_cluster_labels(nodes, float(distance_threshold))
    num_clusters = int(labels.max()) + 1 if labels.size else 0
    cluster_centers = np.zeros((num_clusters, 2), dtype=np.float32)
    cluster_size = np.zeros((num_clusters,), dtype=np.float32)
    np.add.at(cluster_centers, labels, nodes.astype(np.float32))
    np.add.at(cluster_size, labels, 1.0)
    cluster_centers = cluster_centers / cluster_size[:, None]
    unique_edges = set()
    for start, end in edges:
        new_start = int(labels[start])
        new_end = int(labels[end])
        if new_start == new_end:
            continue
        unique_edges.add((min(new_start, new_end), max(new_start, new_end)))
    return cluster_centers, sorted(unique_edges)


def split_edges(nodes, edges, distance_threshold):
    """Recursively split edges at the nearest non-endpoint node closer than
    distance_threshold (reference: graph_utils.py:317-357).

    Candidates mirror the reference's STRtree bbox query over the segment's
    flat-cap buffer: points inside the buffer polygon's bounding box.
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    thresh = float(distance_threshold)
    index = PointGridIndex(nodes, cell_size=max(thresh * 2, 1e-6))

    edge_queue = deque()
    for edge in edges:
        edge_queue.appendleft(tuple(int(v) for v in edge))
    new_edges = []

    while edge_queue:
        start, end = edge_queue.pop()
        a, b = nodes[start], nodes[end]
        # Flat-cap buffer polygon bbox: rectangle spanned by the segment
        # extruded +-thresh perpendicular to its direction.
        ab = b - a
        norm = np.linalg.norm(ab)
        if norm == 0:
            perp = np.zeros(2)
        else:
            perp = np.array([-ab[1], ab[0]]) / norm * thresh
        corners = np.stack([a + perp, a - perp, b + perp, b - perp])
        box = (
            corners[:, 0].min(),
            corners[:, 1].min(),
            corners[:, 0].max(),
            corners[:, 1].max(),
        )
        cand = index.query_box(box)
        cand = cand[(cand != start) & (cand != end)]
        min_dist = thresh + 88.8  # sentinel, matches reference
        nearest = None
        if cand.size:
            d, _ = point_segment_distance(nodes[cand], a, b)
            k = int(np.argmin(d))
            if d[k] < min_dist:
                min_dist, nearest = float(d[k]), int(cand[k])
        if nearest is None or min_dist >= thresh:
            new_edges.append((start, end))
        else:
            edge_queue.appendleft((start, nearest))
            edge_queue.appendleft((nearest, end))

    unique_edges = set()
    for start, end in new_edges:
        unique_edges.add((min(start, end), max(start, end)))
    return nodes, sorted(unique_edges)


def combine_graphs(graphs):
    """Concatenate (nodes, edges) graphs with index offsetting
    (reference: graph_utils.py:360-372)."""
    offset = 0
    combined_nodes, combined_edges = [], []
    for nodes, edges in graphs:
        combined_nodes.append(np.asarray(nodes))
        edges_np = np.array(edges) + offset
        combined_edges.append(edges_np)
        offset += np.asarray(nodes).shape[0]
    return np.concatenate(combined_nodes, axis=0), np.concatenate(combined_edges, axis=0)


def merge_into_large_graph(nodes, edges, merge_node_dist_thresh, split_edge_dist_thresh):
    """Composition pipeline (reference: graph_utils.py:375-380)."""
    nodes1, edges1 = remove_isolate_nodes(nodes, edges)
    nodes2, edges2 = merge_nodes(nodes1, edges1, distance_threshold=merge_node_dist_thresh)
    nodes3, edges3 = split_edges(nodes2, edges2, distance_threshold=split_edge_dist_thresh)
    nodes4, edges4 = remove_isolate_nodes(nodes3, edges3)
    return nodes4, edges4
