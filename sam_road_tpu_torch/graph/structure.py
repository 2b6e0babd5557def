"""Array-backed undirected graphs with CSR adjacency (counterpart of
sam_road_tpu/graph/structure.py, line for line): O(1) neighbour slices,
vectorised subdivision and level-synchronous BFS, for the label generator
(data/graph_labels.py)."""

from __future__ import annotations

import numpy as np

from sam_road_tpu_torch.graph.convert import convert_from_sat2graph_format


class ArrayGraph:
    """Undirected graph over n_vertices vertices: edges [E, 2] int64 (each
    undirected edge once), points [N, 2] float64 vertex coordinates or
    None."""

    def __init__(self, n_vertices: int, edges, points=None):
        self.n_vertices = int(n_vertices)
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        self.edges = edges
        if points is not None:
            points = np.asarray(points, dtype=np.float64).reshape(-1, 2)
        self.points = points
        self._offsets = np.zeros(self.n_vertices + 1, dtype=np.int64)
        if edges.shape[0] > 0:  # CSR over both edge directions
            both = np.concatenate([edges, edges[:, ::-1]], axis=0)
            order = np.argsort(both[:, 0], kind="stable")
            self._adj = both[order, 1]
            np.cumsum(np.bincount(both[:, 0], minlength=self.n_vertices),
                      out=self._offsets[1:])
        else:
            self._adj = np.zeros((0,), dtype=np.int64)

    def neighbors(self, v: int) -> np.ndarray:
        return self._adj[self._offsets[v]:self._offsets[v + 1]]

    def degree(self, v=None):
        counts = np.diff(self._offsets)
        return counts if v is None else int(counts[v])

    def __len__(self):
        return self.n_vertices


def graph_from_adj_dict(adj_dict, coord_transform) -> ArrayGraph:
    """ArrayGraph from a sat2graph adjacency dict: edges de-duplicated as
    unordered pairs, vertex coordinates through coord_transform ([N, 2] ->
    [N, 2], typically (r, c) -> (x, y))."""
    nodes, edges = convert_from_sat2graph_format(adj_dict)
    n_vertices = nodes.shape[0]
    if n_vertices == 0:
        nodes = np.zeros((0, 2), dtype=np.float64)
    if len(edges) > 0:
        e = np.asarray(edges, dtype=np.int64)
        lo = np.minimum(e[:, 0], e[:, 1])
        hi = np.maximum(e[:, 0], e[:, 1])
        dedup = np.unique(np.stack([lo, hi], axis=1), axis=0)
    else:
        dedup = np.zeros((0, 2), dtype=np.int64)
    points = coord_transform(nodes) if n_vertices > 0 else nodes
    return ArrayGraph(n_vertices, dedup, points=points)


def subdivide_graph(graph: ArrayGraph, resolution: float) -> ArrayGraph:
    """Interior points along every edge at about `resolution` spacing: an
    edge of length L becomes max(1, int(L / resolution)) pieces; the
    interior points follow the original vertices, chained by edges."""
    points = graph.points
    edges = graph.edges
    n0 = graph.n_vertices
    if edges.shape[0] == 0:
        return ArrayGraph(n0, edges, points=points)

    p0 = points[edges[:, 0]]
    p1 = points[edges[:, 1]]
    length = np.linalg.norm(p1 - p0, axis=1)
    pieces = np.maximum(1, (length / resolution).astype(np.int64))
    n_interior = pieces - 1
    total_interior = int(n_interior.sum())

    # interior point j of edge e at t = j / pieces_e, j = 1 .. pieces_e - 1
    edge_of_pt = np.repeat(np.arange(edges.shape[0]), n_interior)
    starts = np.concatenate([[0], np.cumsum(n_interior)[:-1]])
    j = np.arange(total_interior) - np.repeat(starts, n_interior) + 1
    t = j / pieces[edge_of_pt]
    interior_pts = p0[edge_of_pt] + t[:, None] * (p1 - p0)[edge_of_pt]

    # edge e becomes the chain (src, i_0), (i_0, i_1), ..., (i_{m-1}, dst)
    total_chain = int(pieces.sum())
    edge_of_chain = np.repeat(np.arange(edges.shape[0]), pieces)
    chain_starts = np.concatenate([[0], np.cumsum(pieces)[:-1]])
    k = np.arange(total_chain) - np.repeat(chain_starts, pieces)
    pt_base = np.repeat(starts, pieces)
    src = np.where(k == 0, edges[edge_of_chain, 0], n0 + pt_base + k - 1)
    dst = np.where(k == pieces[edge_of_chain] - 1, edges[edge_of_chain, 1],
                   n0 + pt_base + k)
    return ArrayGraph(n0 + total_interior, np.stack([src, dst], axis=1),
                      points=np.concatenate([points, interior_pts], axis=0))


def bfs_with_conditions(graph: ArrayGraph, start_node: int, stop_nodes,
                        max_depth: int) -> set:
    """BFS that stops expanding at stop nodes and at max_depth: a node is
    visited when reached and expanded only if it is not a stop node and its
    depth is below max_depth. Returns the set of visited node indices."""
    n = graph.n_vertices
    visited = np.zeros(n, dtype=bool)
    stop_mask = np.zeros(n, dtype=bool)
    stop_arr = np.fromiter(stop_nodes, dtype=np.int64)
    if stop_arr.size:
        stop_mask[stop_arr] = True

    frontier = np.array([start_node], dtype=np.int64)
    visited[frontier] = True
    depth = 0
    adj, offsets = graph._adj, graph._offsets
    while frontier.size > 0 and depth < max_depth:
        expand = frontier[~stop_mask[frontier]]
        if expand.size == 0:
            break
        starts_, ends_ = offsets[expand], offsets[expand + 1]
        counts = ends_ - starts_
        total = int(counts.sum())
        if total == 0:
            break
        base = np.repeat(starts_, counts)
        rel = np.arange(total) - np.repeat(np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
        nbrs = np.unique(adj[base + rel])
        nbrs = nbrs[~visited[nbrs]]
        visited[nbrs] = True
        frontier = nbrs
        depth += 1
    return set(np.nonzero(visited)[0].tolist())
