"""APLS metric — pure-Python implementation (counterpart of
sam_road_tpu/metrics/apls.py).

Behavioral port of the reference Go scorer (reference:
cityscale_metrics/apls/main.go / spacenet_metrics variant): densify both
graphs to ~2 m hops, sample control points along degree!=2 chains, snap GT
control points one-to-one onto proposal nodes (<10 m, with 4-hop coverage
propagation), run multi-source Dijkstra (integer centimeters) between all
control points on both graphs, and score
APLS = 1 - mean(min(1, |d_gt - d_prop| / d_gt)) symmetrically.

Reference quirks preserved deliberately:
- unmatched control-point pairs count 1.0 regardless of d_gt
  (main.go:503-507);
- the coverage propagation during control-point sampling walks the OTHER
  graph with this graph's node id (main.go:312-314) — a cross-graph id mixup
  kept bug-for-bug;
- int-centimeter edge weights (main.go:619).

This is the validation oracle for the C++ production scorer
(native/apls.cc, apls_native.py) and its plain version: it runs only when
the caller asks for it (the runner's use_native=False, the evaluation CLI's
--no_native), never in place of a native build that failed.
"""

from __future__ import annotations

import heapq
import json
import math

import numpy as np
from scipy.spatial import cKDTree

from sam_road_tpu_torch.metrics.latlon import gps_distance, xy2latlon

# cityscale parameters (main.go:17-25); spacenet variant (main.go:717-726)
CITY_PARAMS = dict(interval_1=37, interval_2=25.0, min_distance_filter=100.0,
                   prop_step=4, region_size=2048.0, margin_size=100.0)
# NOTE: the Go CODE sets interval_2 = 15.0 -> interval_1 = int(22.5) = 22
# (main.go:720-721); the "interval 10-15" comment at main.go:295 is stale.
SPACENET_PARAMS = dict(interval_1=22, interval_2=15.0, min_distance_filter=30.0,
                       prop_step=3, region_size=352.0, margin_size=30.0)


def sat2graph_to_apls_json(adj: dict):
    """sat2graph dict -> [nodes(latlon), edges] (reference:
    cityscale_metrics/apls/convert.py:11-58). Edges deduped as unordered."""
    nodes = []
    nodemap = {}
    for k in adj.keys():
        nodemap[k] = len(nodes)
        nodes.append(list(xy2latlon(k[0], k[1])))
    edges = []
    edge_map = set()
    for n1, v in adj.items():
        for n2 in v:
            if (n1, n2) in edge_map or (n2, n1) in edge_map:
                continue
            edge_map.add((n1, n2))
            edges.append([nodemap[n1], nodemap[n2]])
    return [nodes, edges]


class _Graph:
    """Densified graph with loc2key dedup (reference: main.go:27-201)."""

    def __init__(self):
        self.nodes = []
        self.loc2index = {}
        self.neighbors = {}

    @staticmethod
    def loc2key(loc):
        return "%.7f_%.7f" % (loc[0], loc[1])

    def _node_id(self, loc):
        k = self.loc2key(loc)
        if k in self.loc2index:
            return self.loc2index[k]
        nid = len(self.nodes)
        self.nodes.append(tuple(loc))
        self.loc2index[k] = nid
        return nid

    def add_edge(self, loc1, loc2):
        nid1 = self._node_id(loc1)
        nid2 = self._node_id(loc2)
        self.neighbors.setdefault(nid1, {})[nid2] = True
        self.neighbors.setdefault(nid2, {})[nid1] = True

    def degree(self, nid):
        return len(self.neighbors.get(nid, {}))

    def propagate(self, nid, step, action):
        """Bounded BFS applying `action` (reference: main.go:38-68)."""
        visited = {nid: 0}
        queue = [nid]
        while queue:
            cur = queue.pop(0)
            if visited[cur] > step:
                continue
            action(cur)
            for k in self.neighbors.get(cur, {}):
                if k not in visited:
                    queue.append(k)
                    visited[k] = visited[cur] + 1

    def shortest_paths(self, nid1, targets):
        """Multi-target Dijkstra, int centimeter weights
        (reference: main.go:638-695). Returns {target: meters or -1}."""
        result = {v: -1.0 for v in targets}
        mindist = {}
        pq = [(0, nid1)]
        mindist[nid1] = 0
        done = set()
        while pq:
            d, cur = heapq.heappop(pq)
            if cur in done or d > mindist.get(cur, 1 << 62):
                continue
            done.add(cur)
            if cur in result:
                result[cur] = d / 100.0
            cur_loc = self.nodes[cur]
            for nxt in self.neighbors.get(cur, {}):
                w = int(gps_distance(cur_loc, self.nodes[nxt]) * 100.0)
                nd = d + w
                if nd < mindist.get(nxt, 1 << 62):
                    mindist[nxt] = nd
                    heapq.heappush(pq, (nd, nxt))
        return result


def _densify(nodes, edges) -> _Graph:
    """Insert nodes every ~2 m along edges (reference: main.go:203-247)."""
    g = _Graph()
    for n1, n2 in edges:
        a, b = nodes[n1], nodes[n2]
        d = gps_distance(a, b)
        if d > 3.0:
            n = int(d / 2.0) + 1
            for i in range(n):
                alpha1 = i / n
                alpha2 = (i + 1) / n
                loc1 = a if i == 0 else (
                    a[0] * (1 - alpha1) + b[0] * alpha1,
                    a[1] * (1 - alpha1) + b[1] * alpha1,
                )
                loc2 = b if i == n - 1 else (
                    a[0] * (1 - alpha2) + b[0] * alpha2,
                    a[1] * (1 - alpha2) + b[1] * alpha2,
                )
                g.add_edge(loc1, loc2)
        else:
            g.add_edge(a, b)
    return g


def _gps_in_bound(p, params):
    """(reference: main.go:79-93)"""
    region_size = params["region_size"]
    margin_size = params["margin_size"]
    lat_tl, lon_tl = 41.0, -71.0
    lat2 = lat_tl - region_size / 111111.0
    lon2 = lon_tl + region_size / 111111.0 / math.cos(lat_tl / 180.0 * 3.1415926)
    m_lat = margin_size / 111111.0
    m_lon = margin_size / 111111.0 / math.cos(lat_tl / 180.0 * 3.1415926)
    return (
        p[0] > lat2 + m_lat
        and p[0] < lat_tl - m_lat
        and p[1] > lon_tl + m_lon
        and p[1] < lon2 - m_lon
    )


def _lockey(loc, dist):
    return "%d_%d" % (int(loc[0] * 111111.0 / dist), int(loc[1] * 111111.0 / dist))


def _apls_one_way(graph_gt: _Graph, graph_prop: _Graph, params) -> float:
    """(reference: main.go:253-541)"""
    interval_1 = params["interval_1"]
    interval_2 = params["interval_2"]
    min_distance_filter = params["min_distance_filter"]
    prop_step = params["prop_step"]

    visited = set()
    lockeys = set()
    control_point_gt = {}
    node_cover_map_gt = {nid: False for nid in range(len(graph_gt.nodes))}

    def mark_gt(nid):
        node_cover_map_gt[nid] = True

    for nid in range(len(graph_gt.nodes)):
        if graph_gt.degree(nid) != 2:
            for next_nid in graph_gt.neighbors.get(nid, {}):
                if next_nid in visited:
                    continue
                chain = [nid, next_nid]
                last_nid, current_nid = nid, next_nid
                while graph_gt.degree(current_nid) == 2:
                    s = sum(graph_gt.neighbors[current_nid].keys())
                    current_nid, last_nid = s - last_nid, current_nid
                    chain.append(current_nid)

                if len(chain) > interval_1:
                    n = int(len(chain) / interval_2) + 1
                    for i in range(1, n):
                        idx = int(len(chain) * i / n)
                        cn = chain[idx]
                        if _gps_in_bound(graph_gt.nodes[cn], params) and not node_cover_map_gt[cn]:
                            lk = _lockey(graph_gt.nodes[cn], 2.0)
                            if lk not in lockeys:
                                lockeys.add(lk)
                                control_point_gt[cn] = -1
                                # NOTE reference bug kept: propagates on the
                                # PROP graph with a GT node id (main.go:312)
                                if cn < len(graph_prop.nodes):
                                    graph_prop.propagate(cn, 4, mark_gt)
                for cnid in chain:
                    visited.add(cnid)

            if _gps_in_bound(graph_gt.nodes[nid], params) and (
                not node_cover_map_gt[nid] or graph_gt.degree(nid) == 1
            ):
                lk = _lockey(graph_gt.nodes[nid], 2.0)
                if lk not in lockeys:
                    lockeys.add(lk)
                    control_point_gt[nid] = -1
                    if nid < len(graph_prop.nodes):
                        graph_prop.propagate(nid, 4, mark_gt)

    # snap to proposal graph, one-to-one with coverage propagation
    # (reference: main.go:348-394)
    node_cover_map = {nid: False for nid in range(len(graph_prop.nodes))}

    def mark_prop(nid):
        node_cover_map[nid] = True

    prop_nodes = graph_prop.nodes
    if prop_nodes:
        tree = cKDTree(np.asarray(prop_nodes))
        # rtreego (main.go:350-373) orders the 10 candidates by minimum
        # euclidean distance IN RAW lat/lon DEGREES to the tol=1e-6 rect
        # centered on each node (Roussopoulos minDist), not to the point:
        # near-ties within ~2*tol (~0.2 m) can order differently. Query a
        # wider plain-metric set, then re-rank by the rect metric — the
        # plain top-40 always contains the rect top-10 (rect >= plain -
        # tol*sqrt(2), and >30 candidates inside a 0.2 m band cannot occur
        # in a ~2 m-spaced densified graph).
        tol = 1e-6
        for nid1 in control_point_gt:
            q = graph_gt.nodes[nid1]
            k = min(40, len(prop_nodes))
            dd, ii = tree.query(q, k=k)
            if k == 1:
                dd, ii = [dd], [ii]
            ranked = sorted(
                (max(0.0, abs(q[0] - prop_nodes[int(c)][0]) - tol) ** 2
                 + max(0.0, abs(q[1] - prop_nodes[int(c)][1]) - tol) ** 2,
                 int(c))
                for c in np.atleast_1d(ii)
            )
            for _, cand in ranked[:10]:
                if node_cover_map[cand]:
                    continue
                if gps_distance(prop_nodes[cand], q) < 10.0:
                    control_point_gt[nid1] = cand
                    graph_prop.propagate(cand, prop_step, mark_prop)
                    break

    # shortest paths between control points (reference: main.go:410-488)
    control_point_gt_list = []
    control_point_prop_list = []
    seen_prop = set()
    for cp_gt, cp_prop in control_point_gt.items():
        if cp_prop < 0:
            continue
        control_point_gt_list.append(cp_gt)
        if cp_prop not in seen_prop:
            seen_prop.add(cp_prop)
            control_point_prop_list.append(cp_prop)

    sp_prop = {
        cp: graph_prop.shortest_paths(cp, control_point_prop_list)
        for cp in control_point_prop_list
    }
    sp_gt = {
        cp: graph_gt.shortest_paths(cp, control_point_gt_list)
        for cp in control_point_gt_list
    }

    # pair scoring (reference: main.go:491-541)
    cc = 0.0
    total = 0.0
    for cp1_gt, cp1_prop in control_point_gt.items():
        for cp2_gt, cp2_prop in control_point_gt.items():
            if cp2_gt <= cp1_gt:
                continue
            if cp1_prop == -1 or cp2_prop == -1:
                cc += 1.0
                total += 1.0
                continue
            d1 = sp_gt[cp1_gt][cp2_gt]
            if d1 > min_distance_filter:
                d2 = sp_prop[cp1_prop][cp2_prop]
                if d2 < 0:
                    d2 = 0
                s = min(abs(d1 - d2) / d1, 1.0)
                cc += 1.0
                total += s
    if cc == 0:
        return 0.0
    return 1.0 - total / cc


def apls_score(gt_json, prop_json, spacenet: bool = False):
    """Symmetric APLS between two [nodes, edges] JSON graphs
    (reference: main.go:697-738). Returns (apls_gt, apls_prop, mean)."""
    params = SPACENET_PARAMS if spacenet else CITY_PARAMS
    gt_dense = _densify(gt_json[0], gt_json[1])
    prop_dense = _densify(prop_json[0], prop_json[1])
    apls_gt = _apls_one_way(gt_dense, prop_dense, params)
    apls_prop = _apls_one_way(prop_dense, gt_dense, params)
    return apls_gt, apls_prop, (apls_gt + apls_prop) / 2.0


def apls_score_files(gt_path: str, prop_path: str, out_path: str | None = None,
                     spacenet: bool = False):
    with open(gt_path) as f:
        gt = json.load(f)
    with open(prop_path) as f:
        prop = json.load(f)
    a, b, m = apls_score(gt, prop, spacenet=spacenet)
    if out_path:
        with open(out_path, "w") as f:
            f.write("%f %f %f\n" % (a, b, m))
    return a, b, m
