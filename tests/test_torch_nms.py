"""The port's greedy NMS (graph/nms.py over csrc/nms.cc) against a plain
numpy greedy NMS written from the rule alone, bit for bit: the same kept
points in the same order and the same indices, on inputs where every
candidate is immune (score > 1.0), none is, a mix, and NaN scores; and the
module's counters of candidates and of the suppressible points in the grid.
"""

import numpy as np
import pytest

from sam_road_tpu_torch.graph import nms


def _greedy(points, scores, radius):
    """Visit in np.argsort(scores)[::-1] order; a point still kept clears
    every point within radius (float64 dx * dx + dy * dy <= radius^2) whose
    score is not above 1.0, then stays kept. Returns (points, indices)."""
    points = np.asarray(points, np.float64).reshape(-1, 2)
    scores = np.asarray(scores, np.float64).reshape(-1)
    order = np.argsort(scores)[::-1]
    pts, sc = points[order], scores[order]
    kept = np.ones(len(pts), bool)
    clearable = np.nonzero(~(sc > 1.0))[0]
    r2 = float(radius) * float(radius)
    for i in range(len(pts)):
        if not kept[i]:
            continue
        d = pts[clearable] - pts[i]
        kept[clearable[d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] <= r2]] = False
        kept[i] = True
    return pts[kept], order[kept]


def _all_immune(r):
    """Road-mask candidates: 50k distinct pixels of a 256 px square, their
    uint8 values (230-255) as scores, massively tied."""
    flat = r.choice(256 * 256, 50_000, replace=False)
    pts = np.stack([flat % 256, flat // 256], 1)
    return pts, r.integers(230, 256, 50_000).astype(np.uint8), 8


def _none_immune(r):
    """The final pass's shape: priorities 1.0 and 0.0, dense pixels."""
    pts = r.integers(0, 160, (6000, 2)).astype(np.float64)
    return pts, (r.random(6000) < 0.2).astype(np.float64), 8


def _labels_mix(r):
    """graph_labels' label NMS: points along polylines, uniform 0.9-1.0
    scores, forced to 2.0 at a tenth of them (the intersections)."""
    starts = r.uniform(0, 300, (40, 2))
    dirs = r.normal(size=(40, 2))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    steps = np.arange(0, 120, 2.5)
    pts = (starts[:, None] + steps[None, :, None] * dirs[:, None]).reshape(-1, 2)
    scores = r.uniform(0.9, 1.0, len(pts))
    scores[r.random(len(pts)) < 0.1] = 2.0
    return pts, scores, 8.0


def _nan_first(r):
    """NaN scores sort first and are suppressible, so immune points visited
    after them clear them: the pass reaches back to earlier-kept points."""
    pts = r.integers(0, 64, (800, 2)).astype(np.float64)
    scores = r.uniform(0.5, 2.0, 800)
    scores[r.random(800) < 0.05] = np.nan
    return pts, scores, 4


def _single(r):
    return np.array([[3.0, 4.0]]), np.array([0.5]), 8


def _empty(r):
    return np.zeros((0, 2)), np.zeros(0), 8


@pytest.mark.parametrize("make", [_all_immune, _none_immune, _labels_mix, _nan_first, _single,
                                  _empty],
                         ids=lambda f: f.__name__.strip("_"))
def test_nms_matches_plain_greedy(make):
    pts, scores, radius = make(np.random.default_rng(7))
    before = nms.counts.copy()
    got_p, got_i = nms.nms_points(pts, scores, radius, return_indices=True)
    want_p, want_i = _greedy(pts, scores, radius)
    assert got_p.dtype == np.float64 and got_i.dtype == want_i.dtype
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(nms.nms_points(pts, scores, radius), want_p)
    # two calls: the candidates, and the suppressible ones in the grid
    assert nms.counts["candidates"] - before["candidates"] == 2 * len(pts)
    suppressible = int((~(np.asarray(scores, np.float64) > 1.0)).sum())
    assert nms.counts["suppressible"] - before["suppressible"] == 2 * suppressible
