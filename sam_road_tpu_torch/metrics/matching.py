"""Hopcroft-Karp maximum bipartite matching (counterpart of
sam_road_tpu/metrics/matching.py; replacement for the missing hopcroftkarp
dependency; only the matching SIZE feeds the TOPO score, and
maximum-matching size is unique)."""

from __future__ import annotations

from collections import deque

INF = float("inf")


def maximum_matching_size(bigraph: dict) -> int:
    """Size of a maximum matching of {left_key: set(right_key)}."""
    left = list(bigraph.keys())
    right_ids = {}
    adj = []
    for u in left:
        row = []
        for v in bigraph[u]:
            if v not in right_ids:
                right_ids[v] = len(right_ids)
            row.append(right_ids[v])
        adj.append(row)
    n_left, n_right = len(left), len(right_ids)
    return _hopcroft_karp(adj, n_left, n_right)


def maximum_matching_size_pairs(si, ti) -> int:
    """Maximum matching size from parallel edge arrays (vectorized
    adjacency construction — the dict/set build dominates at TOPO scale)."""
    import numpy as np

    si = np.asarray(si, dtype=np.int64)
    ti = np.asarray(ti, dtype=np.int64)
    if si.size == 0:
        return 0
    # dedupe edges, compact both sides
    _, li = np.unique(si, return_inverse=True)
    _, ri = np.unique(ti, return_inverse=True)
    n_left = int(li.max()) + 1
    n_right = int(ri.max()) + 1
    keys = li * n_right + ri
    uk = np.unique(keys)
    li = (uk // n_right).astype(np.int64)
    ri = (uk % n_right).astype(np.int64)
    order = np.argsort(li, kind="stable")
    li, ri = li[order], ri[order]
    starts = np.searchsorted(li, np.arange(n_left + 1))
    adj = [ri[starts[u]:starts[u + 1]].tolist() for u in range(n_left)]
    return _hopcroft_karp(adj, n_left, n_right)


def _hopcroft_karp(adj, n_left, n_right) -> int:
    match_l = [-1] * n_left
    match_r = [-1] * n_right
    dist = [0] * n_left

    def bfs():
        q = deque()
        for u in range(n_left):
            if match_l[u] == -1:
                dist[u] = 0
                q.append(u)
            else:
                dist[u] = INF
        found = False
        while q:
            u = q.popleft()
            for v in adj[u]:
                w = match_r[v]
                if w == -1:
                    found = True
                elif dist[w] == INF:
                    dist[w] = dist[u] + 1
                    q.append(w)
        return found

    def dfs(u):
        for v in adj[u]:
            w = match_r[v]
            if w == -1 or (dist[w] == dist[u] + 1 and dfs(w)):
                match_l[u] = v
                match_r[v] = u
                return True
        dist[u] = INF
        return False

    matching = 0
    while bfs():
        for u in range(n_left):
            if match_l[u] == -1 and dfs(u):
                matching += 1
    return matching
