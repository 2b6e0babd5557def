"""The port's drawing, label masks and label-preparation CLI against cv2 and
the JAX package on the CPU. Every comparison is exact:

- draw_lines against cv2.line (LINE_8) for thicknesses 1-8 on random
  segments: inside the image, leaving it on any side, far outside it,
  zero-length, and along each of the 8 octants, on grayscale and BGR
  images over a random background; draw_disks against cv2.circle(..., -1)
  for radii 1-8 (centres off the image too); draw_rects against a filled
  cv2.rectangle (corners in any order, off the image).
- rasterize_tile_masks against JAX's on random graphs (diagonal roads,
  degree 1-4 nodes, duplicate and self edges) under the Cityscale and the
  SpaceNet transform.
- python -m sam_road_tpu_torch.cli.prepare against the JAX CLI on
  tests/synthetic_data.py's SpaceNet fixture and on a small Cityscale tree:
  the same PNG files, the decoded masks byte-equal, the same last line.
- A subprocess imports every module this slice adds with no jax, flax,
  sam_road_tpu, cv2, PIL or networkx entering sys.modules.
"""

import json
import os
import pickle
import shutil
import subprocess
import sys

import cv2
import numpy as np
import pytest

from sam_road_tpu.cli import prepare as jprepare
from sam_road_tpu.data.label_gen import rasterize_tile_masks as jrasterize
from sam_road_tpu_torch.cli import prepare
from sam_road_tpu_torch.data.label_gen import rasterize_tile_masks
from sam_road_tpu_torch.data.png import read_png
from sam_road_tpu_torch.utils.viz import draw_disks, draw_lines, draw_rects
from synthetic_data import make_spacenet_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OCTANTS = [(20, 3), (3, 20), (-3, 20), (-20, 3), (-20, -3), (-3, -20), (3, -20), (20, -3),
           (15, 15), (-15, 15), (0, 17), (17, 0)]


def _segments(rng, h, w):
    """Random segments over an h x w image: inside, crossing the border,
    far outside, zero-length, and the octant directions from random
    starts."""
    m = max(h, w)
    segs = []
    for lo, hi, n in ((0, m, 60), (-m // 2, m + m // 2, 60), (-3 * m, 4 * m, 30)):
        a, b = rng.integers(lo, hi, (n, 2)), rng.integers(lo, hi, (n, 2))
        segs += list(zip(a.tolist(), b.tolist()))
    segs += [(p, p) for p in rng.integers(-2, m + 2, (8, 2)).tolist()]
    for dx, dy in OCTANTS:
        x, y = rng.integers(0, m, 2).tolist()
        segs.append(([x, y], [x + dx, y + dy]))
    return segs


@pytest.mark.parametrize("thickness", range(1, 9))
def test_draw_lines_matches_cv2(thickness):
    rng = np.random.default_rng(thickness)
    for h, w, ch in ((48, 64, 1), (61, 37, 3)):
        shape = (h, w) if ch == 1 else (h, w, 3)
        color = (200,) if ch == 1 else (15, 160, 253)
        for p0, p1 in _segments(rng, h, w):
            base = rng.integers(0, 255, shape, dtype=np.uint8)
            want = base.copy()
            cv2.line(want, tuple(p0), tuple(p1), color, thickness)
            got = draw_lines(base.copy(), [p0], [p1], color, thickness)
            assert np.array_equal(got, want), (thickness, shape, p0, p1)


def test_draw_lines_many_at_once():
    """One call over many segments equals cv2.line segment by segment."""
    rng = np.random.default_rng(9)
    segs = _segments(rng, 100, 100)
    p0 = np.array([s[0] for s in segs])
    p1 = np.array([s[1] for s in segs])
    for thickness in (1, 3, 4):
        want = np.zeros((100, 100), np.uint8)
        for a, b in zip(p0.tolist(), p1.tolist()):
            cv2.line(want, tuple(a), tuple(b), 255, thickness)
        got = draw_lines(np.zeros((100, 100), np.uint8), p0, p1, 255, thickness)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("radius", range(1, 9))
def test_draw_disks_matches_cv2(radius):
    rng = np.random.default_rng(100 + radius)
    centers = rng.integers(-radius - 2, 42 + radius, (200, 2))
    for c in centers.tolist():
        for shape, color in (((40, 40), 255), ((40, 40, 3), (0, 255, 255))):
            want = np.zeros(shape, np.uint8)
            cv2.circle(want, tuple(c), radius, color, -1)
            got = draw_disks(np.zeros(shape, np.uint8), [c], radius, color)
            assert np.array_equal(got, want), (radius, shape, c)


def test_draw_rects_matches_cv2():
    rng = np.random.default_rng(7)
    for p0, p1 in zip(rng.integers(-20, 70, (400, 2)).tolist(),
                      rng.integers(-20, 70, (400, 2)).tolist()):
        want = np.zeros((40, 50, 3), np.uint8)
        cv2.rectangle(want, tuple(p0), tuple(p1), (255, 255, 255), -1)
        got = draw_rects(np.zeros((40, 50, 3), np.uint8), [p0], [p1], (255, 255, 255))
        assert np.array_equal(got, want), (p0, p1)


def random_sat2graph(rng, size, n_nodes=60):
    """A random sat2graph dict of (r, c) keys inside a size px tile: a
    spanning tree plus chords, so diagonal roads at every angle and nodes
    of degree 1 to 4 and more; a few duplicate entries, a self edge and a
    node on the tile's border as well."""
    pts = [tuple(int(v) for v in p) for p in rng.integers(0, size, (n_nodes, 2))]
    pts = list(dict.fromkeys(pts)) + [(0, 3), (size - 1, 7)]
    adj = {p: [] for p in pts}

    def link(a, b):
        adj[a].append(b)
        adj[b].append(a)

    for i in range(1, len(pts)):
        link(pts[i], pts[int(rng.integers(0, i))])
    for _ in range(len(pts) // 3):
        a, b = rng.integers(0, len(pts), 2)
        link(pts[a], pts[b])
    adj[pts[0]].append(pts[0])  # self edge
    adj[pts[1]].append(adj[pts[1]][0])  # duplicate
    return adj


TRANSFORMS = {
    "cityscale": (256, lambda n: (int(n[1]), int(n[0]))),
    "spacenet": (400, lambda n: (int(n[1]), 400 - int(n[0]))),
}


@pytest.mark.parametrize("dataset", sorted(TRANSFORMS))
def test_rasterize_tile_masks_matches_jax(dataset):
    size, transform = TRANSFORMS[dataset]
    rng = np.random.default_rng(len(dataset))
    for _ in range(4):
        graph = random_sat2graph(rng, size)
        want = jrasterize(graph, size, transform)
        got = rasterize_tile_masks(graph, size, transform)
        for g, w in zip(got, want):
            assert g.dtype == np.uint8 and g.shape == (size, size)
            np.testing.assert_array_equal(g, w)
        assert want[0].any() and want[1].any()


def _without_processed(src, dst):
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("processed"))


def _compare_processed(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for name in names:
        want = cv2.imread(os.path.join(a, name), cv2.IMREAD_UNCHANGED)
        got = read_png(os.path.join(b, name))
        assert got.dtype == np.uint8 and got.ndim == 2
        np.testing.assert_array_equal(got, want, err_msg=name)
    return names


def _last_line(capsys):
    return capsys.readouterr().out.strip().splitlines()[-1]


def test_prepare_cli_matches_jax_spacenet(tmp_path, capsys):
    jroot, root = str(tmp_path / "jax"), str(tmp_path / "port")
    make_spacenet_fixture(jroot, image_size=400, n_train=2, n_val=1, n_test=2, spacing=60)
    _without_processed(jroot, root)
    shutil.rmtree(os.path.join(jroot, "spacenet", "processed"))
    capsys.readouterr()
    jprepare.main(["--dataset", "spacenet", "--data_root", jroot])
    want_line = _last_line(capsys)
    tiles = prepare.main(["--dataset", "spacenet", "--data_root", root])
    got_line = _last_line(capsys)
    assert got_line == want_line.replace(jroot, root)
    with open(os.path.join(root, "spacenet", "data_split.json")) as f:
        split = json.load(f)
    assert tiles == split["test"] + split["validation"] + split["train"]
    names = _compare_processed(os.path.join(jroot, "spacenet", "processed"),
                               os.path.join(root, "spacenet", "processed"))
    assert len(names) == 2 * 5


def test_prepare_cli_matches_jax_cityscale(tmp_path, capsys):
    """A Cityscale tree with four of the 180 indices (0, 7, 42, 179), random
    2048 px graphs; the others are missing and skipped."""
    jroot, root = str(tmp_path / "jax"), str(tmp_path / "port")
    sat = os.path.join(jroot, "cityscale", "20cities")
    os.makedirs(sat)
    rng = np.random.default_rng(5)
    for tile in (0, 7, 42, 179):
        with open(os.path.join(sat, f"region_{tile}_refine_gt_graph.p"), "wb") as f:
            pickle.dump(random_sat2graph(rng, 2048, n_nodes=150), f)
    _without_processed(jroot, root)
    capsys.readouterr()
    jprepare.main(["--dataset", "cityscale", "--data_root", jroot])
    want_line = _last_line(capsys)
    tiles = prepare.main(["--dataset", "cityscale", "--data_root", root])
    assert _last_line(capsys) == want_line.replace(jroot, root)
    assert tiles == [0, 7, 42, 179]
    _compare_processed(os.path.join(jroot, "cityscale", "processed"),
                       os.path.join(root, "cityscale", "processed"))


NEW_MODULES = (
    "sam_road_tpu_torch.utils.viz", "sam_road_tpu_torch.data.label_gen",
    "sam_road_tpu_torch.cli.prepare", "sam_road_tpu_torch.cli.triage",
    "sam_road_tpu_torch.cli.debug_labels", "sam_road_tpu_torch.graph",
    "sam_road_tpu_torch.graph.merge", "sam_road_tpu_torch.graph.polylines",
    "sam_road_tpu_torch.graph.extraction",
)


def test_new_modules_import_no_jax_cv2_pil_networkx():
    """Each module, its drawing library built and a mask drawn, without
    jax, flax, sam_road_tpu, cv2, PIL or networkx in sys.modules."""
    code = (
        "import importlib, sys\n"
        "import numpy as np\n"
        f"for name in {NEW_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "from sam_road_tpu_torch.data.label_gen import rasterize_tile_masks\n"
        "kp, road = rasterize_tile_masks({(5, 5): [(30, 40)], (30, 40): [(5, 5)]}, 64,\n"
        "                                lambda n: (int(n[1]), int(n[0])))\n"
        "assert kp.any() and road.any()\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'flax', 'sam_road_tpu', 'cv2', 'PIL', 'networkx'))\n"
        "print('LOADED', bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout
