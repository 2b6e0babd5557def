"""The port's graph helpers (graph/merge.py, graph/polylines.py, the legacy
A* and Bresenham extraction in graph/extraction.py, graph/__init__.py)
against the JAX package on the CPU, on tests/test_graph_lib.py's cases and
on seeded random graphs and masks. Every comparison is exact: the same
node arrays (dtype and values), the same edge lists in the same order, the
same polylines, path lengths, cost fields and adjacency dicts.
"""

import types

import numpy as np
import pytest

import sam_road_tpu.graph as JG
import sam_road_tpu_torch.graph as G
from sam_road_tpu.graph import extraction as jextraction
from sam_road_tpu_torch.graph import extraction
from sam_road_tpu_torch.utils.viz import draw_disks, draw_lines
from test_torch_engine import _load_jax_native


def _same(got, want):
    """Equal structure and values; arrays equal in dtype too."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (got, want)
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), (got, want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert got == want


def test_graph_package_exports_the_jax_names():
    assert G.__all__ == JG.__all__
    for name in G.__all__:
        assert callable(getattr(G, name)), name


def _random_graph(seed, n=40, spread=20.0, extra=30):
    """Clustered nodes (near-duplicates for merge_nodes, points near edges
    for split_edges), a random edge list with repeats, both directions and
    self loops, and isolated nodes."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, spread * 5, (n // 2, 2))
    nodes = np.concatenate([centers, centers + rng.normal(0, 0.1, centers.shape)])
    edges = rng.integers(0, n - 4, (extra, 2)).tolist()
    edges += [[b, a] for a, b in edges[:5]] + [[3, 3], edges[0]]
    return nodes, edges


def _grid_graph(seed, side=7, spacing=10.0, jitter=2.0, extra=40, dups=0):
    """Nodes on a jittered grid (at least spacing - 2 * jitter apart), `dups`
    of them repeated 0.1 px away (merged back by merge_nodes), and a random
    edge list with repeats: split_edges' recursion ends on it (between
    nodes closer than its threshold it can split an edge back and forth
    forever, in both packages alike)."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(np.arange(side), np.arange(side)), -1).reshape(-1, 2) * spacing
    nodes = grid + rng.uniform(-jitter, jitter, grid.shape)
    nodes = np.concatenate([nodes, nodes[:dups] + rng.uniform(-0.1, 0.1, (dups, 2))])
    edges = rng.integers(0, nodes.shape[0], (extra, 2)).tolist()
    return nodes, edges + [edges[0], edges[1][::-1]]


# tests/test_graph_lib.py's cases, then seeded random graphs
MERGE_CASES = [
    ("remove_isolate_nodes", (np.array([[0.0, 0.0], [1.0, 1.0], [2.0, 2.0]]), [[0, 2]])),
    ("merge_nodes", (np.array([[0.0, 0.0], [1.0, 1.0], [1.1, 1.1], [2.0, 2.0], [0.1, 0.1]]),
                     [[0, 1], [1, 2], [1, 3], [2, 3], [2, 4]], 0.2)),
    ("split_edges", (np.array([[0.0, 0.0], [1.01, 1.01], [2.0, 2.0], [2.0, 0.0]]),
                     [[0, 1], [1, 2], [0, 2], [2, 3]], 0.2)),
    ("combine_graphs", ([(np.array([[0.0, 0.0], [1.0, 0.0]]), [[0, 1]]),
                         (np.array([[2.0, 2.0], [3.0, 3.0]]), [[0, 1]])],)),
    ("merge_into_large_graph", (np.array([[0.0, 0.0], [0.05, 0.0], [10.0, 0.0], [5.0, 0.05],
                                          [50.0, 50.0]]), [[0, 2], [1, 2], [3, 3]], 0.2, 0.2)),
] + [
    (name, args)
    for seed in (0, 1, 2)
    for name, args in (
        ("remove_isolate_nodes", _random_graph(seed)),
        ("merge_nodes", (*_random_graph(seed), 0.5)),
        ("split_edges", (*_grid_graph(seed), 2.5)),
        ("combine_graphs", ([_random_graph(seed), _random_graph(seed + 10)],)),
        ("merge_into_large_graph", (*_grid_graph(seed, dups=10), 0.5, 2.5)),
    )
]


@pytest.mark.parametrize("name,args", MERGE_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(MERGE_CASES)])
def test_merge_matches_jax(name, args):
    _same(getattr(G, name)(*args), getattr(JG, name)(*args))


def _random_road(seed, n=30):
    """A random road graph: coordinates, a tree of undirected edges (both
    directions) with a few chords, and one isolated loop (the warning
    path of find_segments_in_road_graph)."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 100, (n + 3, 2))
    edges = []
    for i in range(1, n):
        j = int(rng.integers(0, i)) if rng.random() < 0.6 else i - 1
        edges += [[i, j], [j, i]]
    for _ in range(4):
        a, b = (int(v) for v in rng.integers(0, n, 2))
        if a != b:
            edges += [[a, b], [b, a]]
    for a, b in ((n, n + 1), (n + 1, n + 2), (n + 2, n)):
        edges += [[a, b], [b, a]]
    return coords, edges


POLYLINE_GRAPHS = [
    (np.array([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0], [2.0, 1.0]]),
     [[0, 1], [1, 0], [1, 2], [2, 1], [2, 3], [3, 2]]),
    (np.array([[0, 0], [1, 0], [2, 0], [3, 0], [2, 1]], float),
     [[0, 1], [1, 0], [1, 2], [2, 1], [2, 3], [3, 2], [2, 4], [4, 2]]),
] + [_random_road(seed) for seed in range(3)]


@pytest.mark.parametrize("case", range(len(POLYLINE_GRAPHS)))
def test_polylines_match_jax(case):
    coords, edges = POLYLINE_GRAPHS[case]
    adj, jadj = G.edge_list_to_adj_table(coords, edges), JG.edge_list_to_adj_table(coords, edges)
    assert adj == jadj
    first = [e for e in edges if len(adj[e[0]]) != 2][0]
    _same(G.trace_segment(first, adj), JG.trace_segment(first, jadj))
    segments = G.find_segments_in_road_graph(adj)
    _same(segments, JG.find_segments_in_road_graph(jadj))
    normalized = G.normalize_segments(coords, segments)
    _same(normalized, JG.normalize_segments(coords, segments))
    _same(G.get_resampled_polylines(coords, normalized, 9),
          JG.get_resampled_polylines(coords, normalized, 9))
    polylines = G.get_polylines_from_road_graph(coords, edges, 7)
    _same(polylines, JG.get_polylines_from_road_graph(coords, edges, 7))
    for threshold in (0.2, 5.0):
        _same(G.get_polyline_connectivity(polylines, threshold),
              JG.get_polyline_connectivity(polylines, threshold))


def test_polyline_connectivity_matches_jax():
    a = np.array([[0.0, 0.0], [1.0, 0.0]])
    b = np.array([[1.0, 0.05], [2.0, 0.0]])
    c = np.array([[5.0, 5.0], [6.0, 5.0]])
    _same(G.get_polyline_connectivity([a, b, c], 0.2),
          JG.get_polyline_connectivity([a, b, c], 0.2))


def _road_masks(seed, size=96):
    """uint8 keypoint and road masks of a random street network: roads as
    lines of width 5 (gaps included), keypoints as disks at the crossings
    and ends, and noise below the thresholds."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(8, size - 8, (9, 2))
    road = (rng.integers(0, 60, (size, size))).astype(np.uint8)
    kp = (rng.integers(0, 40, (size, size))).astype(np.uint8)
    a, b = pts[[0, 1, 2, 3, 4, 5, 6]], pts[[1, 2, 3, 4, 5, 6, 7]]
    draw_lines(road, a, b, 230, 5)
    draw_disks(kp, pts, 3, 250)
    return kp, road


LEGACY_CONFIG = types.SimpleNamespace(ITSC_THRESHOLD=0.5, ROAD_THRESHOLD=0.5, ITSC_NMS_RADIUS=4,
                                      ROAD_NMS_RADIUS=8, NEIGHBOR_RADIUS=24)


@pytest.mark.parametrize("seed", range(3))
def test_legacy_extraction_matches_jax(seed):
    _load_jax_native()
    kp, road = _road_masks(seed)
    rng = np.random.default_rng(seed + 100)
    cost = rng.integers(0, 4, (24, 24)).astype(np.uint8)
    for _ in range(6):
        s, e = (tuple(int(v) for v in rng.integers(0, 24, 2)) for _ in range(2))
        assert (extraction.astar_path_length(cost, s, e, 40)
                == jextraction.astar_path_length(cost, s, e, 40))

    pts = extraction.extract_graph_points(kp, road, LEGACY_CONFIG)
    _same(pts, jextraction.extract_graph_points(kp, road, LEGACY_CONFIG))
    field = extraction.create_cost_field_astar(pts, road)
    _same(field, jextraction.create_cost_field_astar(pts, road))
    jfield = field.copy()
    for p, q in zip(pts[:-1], pts[1:]):
        assert (extraction.is_connected_astar(field, p, q, 24)
                == jextraction.is_connected_astar(jfield, p, q, 24))
        _same(field, jfield)
    adj = extraction.extract_graph_astar(kp, road, LEGACY_CONFIG)
    assert adj == jextraction.extract_graph_astar(kp, road, LEGACY_CONFIG) and adj

    field = extraction.create_cost_field(pts, road)
    _same(field, jextraction.create_cost_field(pts, road))
    jfield = field.copy()
    for p, q in zip(pts[:-2], pts[2:]):
        assert (extraction.is_connected_bresenham(field, p, q)
                == jextraction.is_connected_bresenham(jfield, p, q))
        _same(field, jfield)
