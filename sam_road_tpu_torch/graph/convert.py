"""Graph format converters (counterpart of sam_road_tpu/graph/convert.py):
the sat2graph format is a dict {(r, c): [(r, c) neighbour, ...]}, as in the
GT pickles and the inference CLI's graph/{id}.p that the metrics read."""

from __future__ import annotations

import numpy as np


def filter_nodes(node_array, edge_array, keep_node):
    """Drop the nodes where keep_node is False, renumber the edges and drop
    those that lost an end. Returns (nodes, edges [E, 2])."""
    node_array = np.asarray(node_array)
    edge_array = np.asarray(edge_array).reshape(-1, 2)
    keep_node = np.asarray(keep_node, dtype=bool)
    keep_indices = np.where(keep_node)[0]
    old_to_new = np.full((node_array.shape[0],), -1, dtype=np.int32)
    old_to_new[keep_indices] = np.arange(keep_indices.shape[0], dtype=np.int32)
    new_edges = old_to_new[edge_array.flatten()].reshape(-1, 2)
    return node_array[keep_node, :], new_edges[np.all(new_edges > -1, axis=-1), :]


def edge_list_to_adj_table(nodes, edges):
    """Adjacency table: one set of neighbour indices per node."""
    adj_table = [set() for _ in range(len(nodes))]
    for edge in edges:
        adj_table[int(edge[0])].add(int(edge[1]))
    return adj_table


def convert_from_sat2graph_format(graph: dict):
    """sat2graph dict -> (nodes [N, 2], edge index list). Edges keep both
    directions and are not de-duplicated; nodes are numbered in order of
    first appearance in the dict's iteration."""
    node_to_idx = {}
    for node, neighbors in graph.items():
        for n in (node, *neighbors):
            if n not in node_to_idx:
                node_to_idx[n] = len(node_to_idx)
    edges = [(node_to_idx[node], node_to_idx[nb])
             for node, neighbors in graph.items() for nb in neighbors]
    nodes = [None] * len(node_to_idx)
    for node, idx in node_to_idx.items():
        nodes[idx] = node
    return np.array(nodes), edges


def convert_to_sat2graph_format(nodes, edges) -> dict:
    """Array graph -> sat2graph dict: edges in both directions, node keys
    rounded to int (row, col), each neighbour list in the iteration order of
    the node's neighbour set (as the reference's graph_utils.py builds it)."""
    nodes = np.asarray(nodes)
    edges = np.asarray(edges).reshape(-1, 2)
    adj_table = edge_list_to_adj_table(nodes, np.concatenate((edges, edges[:, ::-1]), axis=0))
    int_nodes = [(round(float(x)), round(float(y))) for x, y in nodes]
    return {int_nodes[i]: [int_nodes[j] for j in neighbours]
            for i, neighbours in enumerate(adj_table)}


def convert_from_nx(graph):
    """networkx-like graph with (x, y) nodes -> ((r, c) nodes, edges)
    (reference: graph_utils.py:437-453). Takes any object with .nodes() and
    .edges() iterables, so it needs no networkx."""
    node_to_idx = {}
    nodes = []
    for node in graph.nodes():
        if node not in node_to_idx:
            node_to_idx[node] = len(node_to_idx)
        x, y = node
        nodes.append((y, x))  # to (row, col)
    edges = [(node_to_idx[a], node_to_idx[b]) for a, b in graph.edges()]
    return np.array(nodes), np.array(edges)


def inspect_graph(node_array, edge_array):
    """Debug statistics: one-way edge count + near-duplicate node count
    (reference: graph_utils.py:18-37)."""
    node_array = np.asarray(node_array)
    edge_set = {(int(e[0]), int(e[1])) for e in np.asarray(edge_array).reshape(-1, 2)}
    one_way_edge_count = sum(1 for s, d in edge_set if (d, s) not in edge_set)
    print(f"DEBUG: One-way-edge count {one_way_edge_count}")
    diff = node_array[:, None, :] - node_array[None, :, :]
    dist = np.sqrt((diff**2).sum(-1))
    dup = (np.sum(dist < 0.1) - node_array.shape[0]) / 2
    print(f"DEBUG: duplicate_node_count: {dup}")
    return one_way_edge_count, dup
