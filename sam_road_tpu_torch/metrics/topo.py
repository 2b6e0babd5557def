"""TOPO metric (counterpart of sam_road_tpu/metrics/topo.py; reference:
topo/topo.py + topo/main.py).

Pipeline per tile: control/starting points along GT chains
(TOPOGenerateStartingPoints) -> snap each to the nearest proposal edge with
an angle gate (TOPOGeneratePairs) -> for each matched pair, walk marbles
(proposal) and holes (GT) within radius r and compute precision/recall via
maximum bipartite matching (TOPOWithPairs) -> one-to-one dedup of overlapping
start points (TOPO121) -> averaged P/R.

rtree candidate lookups are replaced by cKDTree box supersets: every
reference rtree query is a bbox prefilter ahead of an exact distance test, so
any candidate superset is behavior-preserving.
"""

from __future__ import annotations

import ctypes
import itertools
import math

import numpy as np
from scipy.spatial import cKDTree

from sam_road_tpu_torch.metrics._native import load_topo_native
from sam_road_tpu_torch.metrics.latlon import (
    LAT_TOP_LEFT,
    LON_TOP_LEFT,
    distance,
    latlon_norm,
    point_to_line_distance_latlon,
)
from sam_road_tpu_torch.metrics.matching import maximum_matching_size_pairs
from sam_road_tpu_torch.metrics.topo_graph import create_graph_from_adj


def TOPOGenerateStartingPoints(OSMMap, density=0.00050, region=None, mergin=0.07):
    """Control points every ~density degrees along GT chains, with a
    `mergin`-fraction in-bound margin (reference: topo/topo.py:100-236,
    image/metaData paths omitted — main.py always passes image='NULL',
    metaData=None)."""
    result = []
    visitedNodes = set()
    for nodeid in OSMMap.nodes.keys():
        if nodeid in visitedNodes:
            continue
        next_nodes = {}
        for nn in OSMMap.nodeLink[nodeid] + OSMMap.nodeLinkReverse[nodeid]:
            next_nodes[nn] = 1
        if len(next_nodes) == 2:
            continue

        for nextnode in next_nodes.keys():
            if nextnode in visitedNodes:
                continue
            node_list = [nodeid]
            cur_node = nextnode
            while True:
                node_list.append(cur_node)
                neighbor = {}
                for nn in OSMMap.nodeLink[cur_node] + OSMMap.nodeLinkReverse[cur_node]:
                    neighbor[nn] = 1
                if len(neighbor) != 2:
                    break
                keys = list(neighbor.keys())
                cur_node = keys[1] if node_list[-2] == keys[0] else keys[0]

            for i in range(1, len(node_list) - 1):
                visitedNodes.add(node_list[i])

            dists = []
            dist = 0.0
            for i in range(0, len(node_list) - 1):
                dists.append(dist)
                dist += distance(
                    OSMMap.nodes[node_list[i]], OSMMap.nodes[node_list[i + 1]]
                )
            dists.append(dist)
            if dist < density / 2:
                continue
            n = max(int(dist / density), 1)
            alphas = [float(x + 1) / float(n + 1) for x in range(n)]

            for alpha in alphas:
                for j in range(len(node_list) - 1):
                    if dists[j] <= alpha * dist <= dists[j + 1]:
                        a = (alpha * dist - dists[j]) / (dists[j + 1] - dists[j])
                        lat = (1 - a) * OSMMap.nodes[node_list[j]][0] + a * OSMMap.nodes[
                            node_list[j + 1]
                        ][0]
                        lon = (1 - a) * OSMMap.nodes[node_list[j]][1] + a * OSMMap.nodes[
                            node_list[j + 1]
                        ][1]
                        lat_mergin = mergin * (region[2] - region[0])
                        lon_mergin = mergin * (region[3] - region[1])
                        if (
                            lat - region[0] > lat_mergin
                            and region[2] - lat > lat_mergin
                            and lon - region[1] > lon_mergin
                            and region[3] - lon > lon_mergin
                        ):
                            result.append(
                                (
                                    lat,
                                    lon,
                                    node_list[j],
                                    node_list[j + 1],
                                    alpha * dist - dists[j],
                                    dists[j + 1] - alpha * dist,
                                )
                            )
    return result


def TOPOGeneratePairs(GPSMap, OSMMap, OSMList, threshold=0.00010, region=None):
    """Snap each GT starting point to the nearest proposal edge within
    `threshold` and a 15-degree angle gate (reference: topo/topo.py:242-370).

    Returns {start_index: [edgeid, n1, n2, d(n1, pt), d(n2, pt), lat, lon]}.
    """
    result = {}
    edges = GPSMap.edges
    if len(edges) == 0:
        return result
    # candidate lookup: edge-midpoint KD-tree with radius covering the
    # reference's bbox prefilter (superset; exact filters follow)
    mids, half_diag, edge_ids = [], [], []
    for edgeid, (n1, n2) in edges.items():
        lat1, lon1 = GPSMap.nodes[n1]
        lat2, lon2 = GPSMap.nodes[n2]
        mids.append(((lat1 + lat2) / 2, (lon1 + lon2) / 2))
        half_diag.append(
            math.hypot((lat1 - lat2) / 2, (lon1 - lon2) / 2)
        )
        edge_ids.append(edgeid)
    mids = np.asarray(mids)
    half_diag = np.asarray(half_diag)
    tree = cKDTree(mids)
    max_half = float(half_diag.max()) if len(half_diag) else 0.0

    for i, item in enumerate(OSMList):
        lat, lon = item[0], item[1]
        cand = tree.query_ball_point(
            [lat, lon], r=(threshold * 2) * 1.5 + max_half, p=np.inf
        )
        min_dist = 10000
        min_edge = -1
        for ci in cand:
            edgeid = edge_ids[ci]
            n1, n2 = edges[edgeid]
            n3, n4 = item[2], item[3]
            lat1, lon1 = GPSMap.nodes[n1]
            lat2, lon2 = GPSMap.nodes[n2]
            lat3, lon3 = OSMMap.nodes[n3]
            lat4, lon4 = OSMMap.nodes[n4]
            nlat1, nlon1 = latlon_norm((lat2 - lat1, lon2 - lon1))
            nlat2, nlon2 = latlon_norm((lat4 - lat3, lon4 - lon3))
            dist = point_to_line_distance_latlon((lat1, lon1), (lat2, lon2), (lat, lon))
            if dist < threshold and dist < min_dist:
                angle_dist = 1.0 - abs(nlat1 * nlat2 + nlon1 * nlon2)
                if angle_dist < 0.04:  # 15 degrees
                    min_edge = edgeid
                    min_dist = dist
        if min_edge != -1:
            n1, n2 = edges[min_edge]
            lat1, lon1 = GPSMap.nodes[n1]
            lat2, lon2 = GPSMap.nodes[n2]
            result[i] = [
                min_edge,
                n1,
                n2,
                distance((lat1, lon1), (lat, lon)),
                distance((lat2, lon2), (lat, lon)),
                lat,
                lon,
            ]
    return result


def _match_count(sources, targets, threshold, one2one):
    """Bipartite matching between marble/hole sets with distance + 45-degree
    angle gates (reference: topo/topo.py:770-896).

    Vectorized: the per-pair distance/angle math ran as tens of millions of
    Python calls per tile (~160 s); candidate pairs are gathered once via a
    KD-tree and filtered with numpy (same semantics — latlon_norm uses the
    reference's fixed lat=40 cosine). native/topo.cc's topo_match runs it;
    the numpy body is the plain version, run when _native.USE_NATIVE is
    False."""
    if len(sources) == 0 or len(targets) == 0:
        return 0
    src = np.ascontiguousarray(np.asarray(sources, dtype=np.float64))  # [S, 4]
    tgt = np.ascontiguousarray(np.asarray(targets, dtype=np.float64))  # [T, 4]

    dll = load_topo_native()
    if dll is not None:
        pf64 = ctypes.POINTER(ctypes.c_double)
        return int(dll.topo_match(
            src.ctypes.data_as(pf64), src.shape[0],
            tgt.ctypes.data_as(pf64), tgt.shape[0],
            float(threshold), int(one2one),
        ))
    ttree = cKDTree(tgt[:, :2])
    rr = threshold * 1.8 + 0.00001
    cand_lists = ttree.query_ball_point(src[:, :2], r=rr, p=np.inf)
    counts = np.fromiter((len(c) for c in cand_lists), dtype=np.int64,
                         count=len(cand_lists))
    if counts.sum() == 0:
        return 0

    si = np.repeat(np.arange(src.shape[0]), counts)
    ti = np.fromiter(itertools.chain.from_iterable(cand_lists),
                     dtype=np.int64, count=int(counts.sum()))

    s = src[si]
    t = tgt[ti]
    # distance(): cos-scaled by the SOURCE latitude (latlon.py:23-27)
    dlat = s[:, 0] - t[:, 0]
    dlon = (s[:, 1] - t[:, 1]) * np.cos(np.radians(s[:, 0]))
    ddd = np.sqrt(dlat * dlat + dlon * dlon)
    # latlon_norm(): fixed lat=40 cosine (latlon.py:30-34)
    c40 = math.cos(math.radians(40))

    def norms(v):  # v: [N, 2] (dlat, dlon)
        a = v[:, 0]
        b = v[:, 1] * c40
        l = np.sqrt(a * a + b * b)
        with np.errstate(divide="ignore", invalid="ignore"):
            return a / l, b / l

    n1a, n1b = norms(s[:, 2:4])
    n2a, n2b = norms(t[:, 2:4])
    both_directed = (s[:, 2] != s[:, 3]) & (t[:, 2] != t[:, 3])
    angle_d = np.where(
        both_directed, 1.0 - np.abs(n1a * n2a + n1b * n2b), 0.0
    )
    ok = (ddd < threshold) & (angle_d < 0.29)  # 45 degrees
    if not ok.any():
        return 0
    si, ti = si[ok], ti[ok]
    if not one2one:
        return int(ok.sum())
    return maximum_matching_size_pairs(si, ti)


def TOPO121(topo_result, roadgraph):
    """One-to-one dedup of overlapping start points via bounded graph
    distance (reference: topo/topo.py:623-681)."""
    if not topo_result:
        return []
    pts = np.asarray([(t[0], t[1]) for t in topo_result])
    tree = cKDTree(pts)
    new_list = []
    for ind in range(len(topo_result)):
        lat, lon = topo_result[ind][0], topo_result[ind][1]
        r_lat = 0.00030
        r_lon = 0.00030 / math.cos(math.radians(lat))
        # bbox superset (exact graph-distance filter follows)
        cand = tree.query_ball_point([lat, lon], r=max(r_lat, r_lon) + 1e-6, p=np.inf)
        competitors = []
        gpsn1, gpsn2, gpsd1, gpsd2 = (
            topo_result[ind][4],
            topo_result[ind][5],
            topo_result[ind][6],
            topo_result[ind][7],
        )
        for can_id in cand:
            # replicate the reference's asymmetric bbox filter
            clat, clon = topo_result[can_id][0], topo_result[can_id][1]
            if not (abs(clat - lat) <= r_lat + 1e-6 and abs(clon - lon) <= r_lon + 1e-6):
                continue
            t = topo_result[can_id]
            d = roadgraph.distanceBetweenTwoLocation(
                (gpsn1, gpsn2, gpsd1, gpsd2), (t[4], t[5], t[6], t[7]),
                max_distance=0.00030,
            )
            if d < 0.00020:
                competitors.append(can_id)
        new_list.append((topo_result[ind], ind, competitors))

    new_list = sorted(new_list, key=lambda item: item[0][2])  # by precision
    result = []
    mark = {}
    for ind in range(len(new_list) - 1, -1, -1):
        if new_list[ind][1] in mark:
            if new_list[ind][0][2] < 0.9:
                continue
        result.append(new_list[ind][0])
        for cc in new_list[ind][2]:
            mark[cc] = 1
    return result


def topoAvg(topo_result):
    if len(topo_result) == 0:
        return 0, 0
    p = sum(item[2] for item in topo_result)
    r = sum(item[3] for item in topo_result)
    return p / len(topo_result), r / len(topo_result)


def TOPOWithPairs(GPSMap, OSMMap, GPSList, OSMList, step=0.00005, r=0.00300,
                  threshold=0.00015, outputfile=None, one2oneMatching=True):
    """Per-pair marble/hole matching -> P/R, TOPO121 dedup, aggregate
    (reference: topo/topo.py:695-958)."""
    i = 0
    precesion_sum = 0.0
    recall_sum = 0.0
    returnResult = []
    lines = []

    for k, itemGPS in GPSList.items():
        itemOSM = OSMList[k]
        gpsn1, gpsn2, gpsd1, gpsd2 = itemGPS[1], itemGPS[2], itemGPS[3], itemGPS[4]
        osmn1, osmn2, osmd1, osmd2 = itemOSM[2], itemOSM[3], itemOSM[4], itemOSM[5]
        lat, lon = itemOSM[0], itemOSM[1]

        marbles = GPSMap.TOPOWalk(
            1, step=step, r=r, newstyle=True,
            nid1=gpsn1, nid2=gpsn2, dist1=gpsd1, dist2=gpsd2,
        )
        holes = OSMMap.TOPOWalk(
            1, step=step, r=r, newstyle=True,
            nid1=osmn1, nid2=osmn2, dist1=osmd1, dist2=osmd2,
        )
        holes_bidirection = OSMMap.TOPOWalk(
            1, step=step, r=r, newstyle=True,
            nid1=osmn1, nid2=osmn2, dist1=osmd1, dist2=osmd2, bidirection=True,
        )
        if len(marbles) == 0 or len(holes) == 0:
            continue

        matchedNum = _match_count(marbles, holes_bidirection, threshold,
                                  one2oneMatching)
        precesion = float(matchedNum) / len(marbles)
        matchedNum = _match_count(holes, marbles, threshold, one2oneMatching)
        recall = float(matchedNum) / len(holes)

        precesion_sum += precesion
        recall_sum += recall
        lines.append(
            f"{i} {lat} {lon} {gpsn1} {gpsn2} Precesion {precesion} Recall "
            f"{recall} Avg Precesion {precesion_sum / (i + 1)} Avg Recall "
            f"{recall_sum / (i + 1)} \n"
        )
        returnResult.append((lat, lon, precesion, recall, gpsn1, gpsn2, gpsd1, gpsd2))
        i += 1

    new_topoResult = TOPO121(returnResult, GPSMap)
    p, rcl = topoAvg(new_topoResult)
    coverage = len(new_topoResult) / float(len(OSMList)) if OSMList else 0.0
    lines.append(f"{p} {rcl} {coverage} {rcl * coverage}\n")
    lines.append(f"precision={p} overall-recall={rcl * coverage}")
    if outputfile:
        with open(outputfile, "w") as fout:
            fout.writelines(lines)
    return new_topoResult, p, rcl * coverage


def topo_score_one_tile(gt_adj: dict, prop_adj: dict, spacenet: bool = False,
                        outputfile=None):
    """Score one tile's sat2graph dicts (reference: topo/main.py:40-154).

    Returns (precision, overall_recall, f1).
    """
    graph_gt, (min_lat_gt, max_lon_gt) = create_graph_from_adj(gt_adj)
    graph_prop, (min_lat_p, max_lon_p) = create_graph_from_adj(prop_adj)
    min_lat = min(min_lat_gt, min_lat_p)
    max_lon = max(max_lon_gt, max_lon_p)

    region = [
        min_lat - 300 * 1.0 / 111111.0,
        LON_TOP_LEFT - 500 * 1.0 / 111111.0,
        LAT_TOP_LEFT + 300 * 1.0 / 111111.0,
        max_lon + 500 * 1.0 / 111111.0,
    ]
    losm = TOPOGenerateStartingPoints(graph_gt, region=region)
    lmap = TOPOGeneratePairs(graph_prop, graph_gt, losm, threshold=0.00010,
                             region=region)
    r = 0.00300
    if spacenet or (LAT_TOP_LEFT - min_lat < 0.01000):
        r = 0.00150
    _, p, overall_recall = TOPOWithPairs(
        graph_prop, graph_gt, lmap, losm, r=r, step=0.00005,
        threshold=0.00010, outputfile=outputfile, one2oneMatching=True,
    )
    if p + overall_recall > 0:
        f1 = 2 * p * overall_recall / (p + overall_recall)
    else:
        f1 = 0.0
    return p, overall_recall, f1
