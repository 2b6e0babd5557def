"""Polyline tracing (counterpart of sam_road_tpu/graph/polylines.py, line for
line; reference: graph_utils.py:96-234): maximal chains between nodes whose
degree is not 2, chain orientation, arc-length resampling (numpy, where the
reference used shapely's LineString.interpolate) and endpoint-overlap
connectivity between polylines.
"""

from __future__ import annotations

import numpy as np

from sam_road_tpu_torch.graph.convert import edge_list_to_adj_table


def unique_edge(src, dst):
    return (min(src, dst), max(src, dst))


def trace_segment(start_edge, adj_table):
    """Walk a chain from start_edge until hitting a branch/terminal
    (reference: graph_utils.py:96-111)."""
    segment_nodes = [start_edge[0], start_edge[1]]
    visited_nodes = set(segment_nodes)
    while True:
        curr_node = segment_nodes[-1]
        unvisited_neighbor_num = 0
        next_node = -1
        for neighbor in adj_table[curr_node]:
            if neighbor not in visited_nodes:
                unvisited_neighbor_num += 1
                next_node = neighbor
        if unvisited_neighbor_num != 1:
            break
        segment_nodes.append(next_node)
        visited_nodes.add(next_node)
    return segment_nodes


def find_segments_in_road_graph(adj_table):
    """All chains whose endpoints have degree != 2
    (reference: graph_utils.py:118-153)."""
    segments = list()
    visited_edges = set()
    node_num = len(adj_table)
    for node in range(node_num):
        if len(adj_table[node]) == 2:
            continue
        for neighbor in adj_table[node]:
            edge = unique_edge(node, neighbor)
            if edge in visited_edges:
                continue
            segment = trace_segment((node, neighbor), adj_table)
            for i in range(len(segment) - 1):
                visited_edges.add(unique_edge(segment[i], segment[i + 1]))
            segments.append(segment)

    all_unique_edges = set()
    for node in range(node_num):
        for neighbor in adj_table[node]:
            all_unique_edges.add(unique_edge(node, neighbor))
    if len(visited_edges) < len(all_unique_edges):
        diff = len(all_unique_edges) - len(visited_edges)
        print(f"!!! Warning: Isolated loop detected. {diff} edges are missing.")
    return segments


def normalize_segments(coords, segments):
    """Orient each chain so the lexicographically-smaller endpoint is first
    (reference: graph_utils.py:156-173)."""
    normalized_segments = []
    for segment in segments:
        first = coords[segment[0], :]
        last = coords[segment[-1], :]
        if first[0] > last[0] or (first[0] == last[0] and first[1] > last[1]):
            segment = segment[::-1]
        normalized_segments.append(segment)
    return normalized_segments


def _interpolate_polyline(polyline_coords: np.ndarray, dists: np.ndarray) -> np.ndarray:
    """Points at arc-length positions along a polyline (numpy equivalent of
    shapely LineString.interpolate, reference graph_utils.py:176-197)."""
    seg_vec = np.diff(polyline_coords, axis=0)
    seg_len = np.linalg.norm(seg_vec, axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    total = cum[-1]
    dists = np.clip(dists, 0.0, total)
    seg_idx = np.clip(np.searchsorted(cum, dists, side="right") - 1, 0, len(seg_len) - 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(seg_len[seg_idx] > 0, (dists - cum[seg_idx]) / seg_len[seg_idx], 0.0)
    return polyline_coords[seg_idx] + t[:, None] * seg_vec[seg_idx]


def get_resampled_polylines(coords, segments, num_points):
    """Uniformly resample each chain to num_points
    (reference: graph_utils.py:176-197)."""
    resampled = []
    for segment in segments:
        polyline_coords = np.asarray(coords)[segment]
        seg_len = np.linalg.norm(np.diff(polyline_coords, axis=0), axis=1).sum()
        dists = np.linspace(0, seg_len, num_points)
        resampled.append(_interpolate_polyline(polyline_coords, dists))
    return resampled


def get_polylines_from_road_graph(coords, edges, num_points_per_segment):
    """Chains -> fixed-length polylines (reference: graph_utils.py:200-206)."""
    coords = np.asarray(coords)
    adj_table = edge_list_to_adj_table(coords, edges)
    segments = find_segments_in_road_graph(adj_table)
    segments = normalize_segments(coords, segments)
    return get_resampled_polylines(coords, segments, num_points_per_segment)


def get_polyline_connectivity(polylines, dist_threshold):
    """Undirected endpoint-overlap connectivity between polylines
    (reference: graph_utils.py:209-234)."""
    connected_pairs = []
    connected_point_indices = []
    polyline_num = len(polylines)
    for i in range(polyline_num):
        for j in range(i + 1, polyline_num):
            a, b = polylines[i], polylines[j]
            endpoint_indices = [
                (0, 0),
                (0, b.shape[0] - 1),
                (a.shape[0] - 1, 0),
                (a.shape[0] - 1, b.shape[0] - 1),
            ]
            for a_idx, b_idx in endpoint_indices:
                if np.linalg.norm(a[a_idx] - b[b_idx]) < dist_threshold:
                    connected_pairs.append((i, j))
                    connected_pairs.append((j, i))
                    connected_point_indices.append((a_idx, b_idx))
                    connected_point_indices.append((b_idx, a_idx))
    return connected_pairs, connected_point_indices
