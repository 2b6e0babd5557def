"""Graph format converters (counterpart of sam_road_tpu/graph/convert.py, the
two that graph/structure.py and the metrics need): the sat2graph format is
a dict {(r, c): [(r, c) neighbour, ...]}, as in the GT pickles."""

from __future__ import annotations

import numpy as np


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
