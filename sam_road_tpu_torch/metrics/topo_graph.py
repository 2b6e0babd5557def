"""Directed road graph for the TOPO metric (counterpart of
sam_road_tpu/metrics/topo_graph.py).

Behavioral port of the reference RoadGraph (reference: topo/graph.py:21-747):
directed adjacency + reverse links, the marble/hole-emitting TOPOWalk BFS
(including the edge_covered bookkeeping and the duplicate-marble bidirection
hack at topo/graph.py:477-479,643-645), and the bounded graph-distance BFS
used by TOPO121.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np

from sam_road_tpu_torch.metrics.latlon import distance, xy2latlon
from sam_road_tpu_torch.metrics._native import load_topo_native


class TopoGraph:
    def __init__(self):
        self.nodes = {}  # id -> [lat, lon]
        self.nodeLink = {}  # id -> [next ids] (insertion order)
        self.nodeLinkReverse = {}  # id -> [prev ids]
        self.nodeHash = {}  # external id -> local id
        self.edgeHash = set()  # (local1, local2)
        self._edge_list = []  # insertion order, mirrors reference edge ids
        self.nodeID = 0
        self._handle = None  # native graph handle (built lazily)
        self._dll = None  # the library that made it

    def __del__(self):
        self._drop_handle()

    def _drop_handle(self):
        if self._handle is not None:
            self._dll.topo_graph_free(self._handle)
            self._handle = None

    def _native_handle(self):
        """Build (once) the native CSR mirror of this graph; None when
        _native.USE_NATIVE is False. Insertion order of nodeLink /
        nodeLinkReverse is preserved — TOPOWalk's marble stream depends on
        neighbor iteration order."""
        dll = load_topo_native()
        if dll is None:
            return None, None
        if self._handle is None:
            n = self.nodeID
            latlon = np.zeros((n, 2), np.float64)
            for i in range(n):
                latlon[i, 0], latlon[i, 1] = self.nodes[i]
            fwd_off = np.zeros(n + 1, np.int64)
            rev_off = np.zeros(n + 1, np.int64)
            for i in range(n):
                fwd_off[i + 1] = fwd_off[i] + len(self.nodeLink.get(i, ()))
                rev_off[i + 1] = rev_off[i] + len(self.nodeLinkReverse.get(i, ()))
            fwd_adj = np.zeros(int(fwd_off[-1]), np.int64)
            rev_adj = np.zeros(int(rev_off[-1]), np.int64)
            for i in range(n):
                fwd_adj[fwd_off[i]:fwd_off[i + 1]] = self.nodeLink.get(i, ())
                rev_adj[rev_off[i]:rev_off[i + 1]] = self.nodeLinkReverse.get(i, ())
            p = ctypes.POINTER(ctypes.c_int64)
            self._dll = dll
            self._handle = dll.topo_graph_create(
                n, latlon.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                fwd_off.ctypes.data_as(p), fwd_adj.ctypes.data_as(p),
                rev_off.ctypes.data_as(p), rev_adj.ctypes.data_as(p),
            )
        return dll, self._handle

    def addEdge(self, nid1, lat1, lon1, nid2, lat2, lon2):
        """(reference: topo/graph.py:89-131)"""
        if nid1 not in self.nodeHash:
            self.nodeHash[nid1] = self.nodeID
            self.nodes[self.nodeID] = [lat1, lon1]
            self.nodeLink[self.nodeID] = []
            self.nodeID += 1
        if nid2 not in self.nodeHash:
            self.nodeHash[nid2] = self.nodeID
            self.nodes[self.nodeID] = [lat2, lon2]
            self.nodeLink[self.nodeID] = []
            self.nodeID += 1
        localid1 = self.nodeHash[nid1]
        localid2 = self.nodeHash[nid2]
        if (localid1, localid2) in self.edgeHash:
            return
        self.edgeHash.add((localid1, localid2))
        self._edge_list.append([localid1, localid2])
        if localid2 not in self.nodeLink[localid1]:
            self.nodeLink[localid1].append(localid2)
        self._drop_handle()  # graph mutated; native mirror is stale

    @property
    def edges(self):
        return {i: e for i, e in enumerate(self._edge_list)}

    def ReverseDirectionLink(self):
        """(reference: topo/graph.py:176-193)"""
        self._drop_handle()
        self.nodeLinkReverse = {}
        for (a, b) in self.edgeHash:
            self.nodeLinkReverse.setdefault(b, [])
            if a not in self.nodeLinkReverse[b]:
                self.nodeLinkReverse[b].append(a)
        for nodeId in self.nodes:
            self.nodeLinkReverse.setdefault(nodeId, [])

    def TOPOWalk(self, nodeid, step=0.00005, r=0.00300, direction=False,
                 newstyle=False, nid1=0, nid2=0, dist1=0, dist2=0,
                 bidirection=False):
        """Emit 'marbles' every ~step along all paths within graph distance r
        of the start location (reference: topo/graph.py:429-683).

        With newstyle=True the walk starts mid-edge at (nid1, nid2) with
        distances dist1/dist2 to the endpoints. Each marble is
        (lat, lon, dlat, dlon) carrying the local edge direction. With
        bidirection=True, edges present in both directions emit a duplicate
        marble offset by +0.00001 (the reference's precision-side hack).

        Hot path: runs the C++ port (native/topo.cc) — identical marble
        stream (tests assert bit-equality); this pure-Python body is the
        spec and the plain version, run when _native.USE_NATIVE is False.
        """
        dll, handle = self._native_handle()
        if dll is not None:
            cap = 65536
            while True:
                out = np.empty((cap, 4), np.float64)
                n = dll.topo_walk(
                    handle, nodeid, step, r, int(direction), int(newstyle),
                    nid1, nid2, dist1, dist2, int(bidirection),
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap,
                )
                if n <= cap:
                    # ndarray [n, 4] — duck-compatible with the fallback's
                    # list of tuples for every consumer (len / np.asarray)
                    return out[:n].copy()
                cap = n

        localNodeDistance = {}
        mables = []
        mables_set = set()
        edge_covered = {}

        if not newstyle:
            Queue = [(nodeid, -1, 0)]
        else:
            Queue = [(nid1, -1, dist1), (nid2, -1, dist2)]

        # Seed marbles between nid1 and nid2 (reference: topo/graph.py:453-484)
        lat1, lon1 = self.nodes[nid1]
        lat2, lon2 = self.nodes[nid2]
        l = distance((lat2, lon2), (lat1, lon1))
        if l > 0:
            alpha = 0.0
            while True:
                latI = lat1 * alpha + lat2 * (1 - alpha)
                lonI = lon1 * alpha + lon2 * (1 - alpha)
                d1 = distance((latI, lonI), (lat1, lon1))
                d2 = distance((latI, lonI), (lat2, lon2))
                if dist1 - d1 < r or dist2 - d2 < r:
                    m = (latI, lonI, lat2 - lat1, lon2 - lon1)
                    if m not in mables_set:
                        mables_set.add(m)
                        mables.append(m)
                        if bidirection:
                            if nid1 in self.nodeLink[nid2] and nid2 in self.nodeLink[nid1]:
                                mables.append(
                                    (latI + 0.00001, lonI + 0.00001,
                                     lat2 - lat1, lon2 - lon1)
                                )
                alpha += step / l
                if alpha > 1.0:
                    break

        while Queue:
            node_cur, node_prev, dist = Queue.pop(0)
            old_node_dist = 1
            if node_cur in localNodeDistance:
                old_node_dist = localNodeDistance[node_cur]
                if localNodeDistance[node_cur] <= dist:
                    continue
            if dist > r:
                continue

            localNodeDistance[node_cur] = dist
            reverseList = [] if direction else self.nodeLinkReverse.get(node_cur, [])

            visited_next_node = []
            for next_node in self.nodeLink[node_cur] + reverseList:
                if next_node in (node_prev, node_cur, nid1, nid2):
                    continue
                if next_node in visited_next_node:
                    continue
                visited_next_node.append(next_node)

                lat1, lon1 = self.nodes[node_cur]
                lat2, lon2 = self.nodes[next_node]
                l = distance((lat2, lon2), (lat1, lon1))
                bias = step * math.ceil(dist / step) - dist
                cur = bias

                if old_node_dist + l < r:
                    Queue.append((next_node, node_cur, dist + l))
                else:
                    start_limitation = edge_covered.get((node_cur, next_node), 0)
                    end_limitation = l - edge_covered.get((next_node, node_cur), 0)
                    while cur < l:
                        alpha = cur / l
                        if dist + l * alpha > r:
                            break
                        if l * alpha < start_limitation:
                            cur += step
                            continue
                        if l * alpha > end_limitation:
                            break
                        latI = lat2 * alpha + lat1 * (1 - alpha)
                        lonI = lon2 * alpha + lon1 * (1 - alpha)
                        m = (latI, lonI, lat2 - lat1, lon2 - lon1)
                        if m not in mables_set:
                            mables_set.add(m)
                            mables.append(m)
                            if bidirection:
                                if (
                                    next_node in self.nodeLink[node_cur]
                                    and node_cur in self.nodeLink[next_node]
                                ):
                                    mables.append(
                                        (latI + 0.00001, lonI + 0.00001,
                                         lat2 - lat1, lon2 - lon1)
                                    )
                        cur += step
                    edge_covered[(node_cur, next_node)] = cur - step
                    Queue.append((next_node, node_cur, dist + l))

        return mables

    def distanceBetweenTwoLocation(self, loc1, loc2, max_distance):
        """Graph distance between two mid-edge locations
        (reference: topo/graph.py:313-425). loc = (n1, n2, d1, d2)."""
        dll, handle = self._native_handle()
        if dll is not None:
            return dll.topo_loc_distance(
                handle, int(loc1[0]), int(loc1[1]), float(loc1[2]),
                float(loc1[3]), int(loc2[0]), int(loc2[1]), float(loc2[2]),
                float(loc2[3]), float(max_distance),
            )
        if loc1[0] == loc2[0] and loc1[1] == loc2[1]:
            return abs(loc1[2] - loc2[2])
        if loc1[0] == loc2[1] and loc1[1] == loc2[0]:
            return abs(loc1[2] - loc2[3])

        ans_dist = 100000
        localNodeDistance = {}
        Queue = [(loc1[0], -1, loc1[2]), (loc1[1], -1, loc1[2])]
        while Queue:
            node_cur, node_prev, dist = Queue.pop(0)
            if node_cur in localNodeDistance and localNodeDistance[node_cur] <= dist:
                continue
            if dist > max_distance:
                continue
            localNodeDistance[node_cur] = dist
            reverseList = self.nodeLinkReverse.get(node_cur, [])
            visited_next_node = []
            for next_node in self.nodeLink[node_cur] + reverseList:
                if next_node in (node_prev, node_cur, loc1[0], loc1[1]):
                    continue
                if next_node in visited_next_node:
                    continue
                visited_next_node.append(next_node)
                lat1, lon1 = self.nodes[node_cur]
                lat2, lon2 = self.nodes[next_node]
                if node_cur == loc2[0] and next_node == loc2[1]:
                    ans_dist = min(ans_dist, dist + loc2[2])
                elif node_cur == loc2[1] and next_node == loc2[0]:
                    ans_dist = min(ans_dist, dist + loc2[3])
                l = distance((lat2, lon2), (lat1, lon1))
                Queue.append((next_node, node_cur, dist + l))
        return ans_dist


def create_graph_from_adj(adj: dict) -> tuple:
    """sat2graph adjacency dict -> (TopoGraph, region)
    (reference: topo/main.py:63-133). Returns the graph and the
    (min_lat, min_lon, max_lat, max_lon)-extent bookkeeping values
    (min_lat, max_lon)."""
    graph = TopoGraph()
    min_lat, max_lon = 41.0, -71.0
    idmap = {}
    nid = 0
    for k, v in adj.items():
        lat1, lon1 = xy2latlon(k[0], k[1])
        min_lat = min(min_lat, lat1)
        max_lon = max(max_lon, lon1)
        for n2 in v:
            lat2, lon2 = xy2latlon(n2[0], n2[1])
            if k in idmap:
                id1 = idmap[k]
            else:
                id1 = nid
                idmap[k] = nid
                nid += 1
            if n2 in idmap:
                id2 = idmap[n2]
            else:
                id2 = nid
                idmap[n2] = nid
                nid += 1
            graph.addEdge(id1, lat1, lon1, id2, lat2, lon2)
    graph.ReverseDirectionLink()
    return graph, (min_lat, max_lon)
