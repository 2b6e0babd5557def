"""The port's graph rasterisation, triage overlays and the two diagnostic
CLIs (python -m sam_road_tpu_torch.cli.triage / .cli.debug_labels) against
the JAX package on the CPU:

- rasterize_graph equal to JAX's cv2 drawing (squares and lines of width
  2r), float32 and float64 nodes, nodes past the image's edges.
- visualize_pred_gt_pair equal to JAX's on the drawn pixels (found by
  drawing both graphs over a black tile) and within 1 level elsewhere:
  the 400 px tile is resized to 512 px by a bilinear resize that differs
  from cv2's fixed point by at most 1 level.
- cli.triage after random.seed(0) writes the JAX CLI's file names and
  images (drawn pixels equal, the rest within 1 level).
- cli.debug_labels writes the JAX CLI's PNGs, pixel for pixel, for the
  same --seed (no resize there).
"""

import os
import pickle
import random

import cv2
import numpy as np
import pytest

from sam_road_tpu.cli import debug_labels as jdebug_labels
from sam_road_tpu.cli import triage as jtriage
from sam_road_tpu.utils.viz import rasterize_graph as jrasterize_graph
from sam_road_tpu.utils.viz import visualize_image_and_graph as jviz
from sam_road_tpu.utils.viz import visualize_pred_gt_pair as jpair
from sam_road_tpu_torch.cli import debug_labels, triage
from sam_road_tpu_torch.config import read_flat_yaml, write_flat_yaml
from sam_road_tpu_torch.data.png import read_png
from sam_road_tpu_torch.utils.viz import rasterize_graph, visualize_pred_gt_pair
from synthetic_data import make_spacenet_fixture
from test_torch_engine import _load_jax_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("radius", [1, 2, 3, 5])
def test_rasterize_graph_matches_jax(radius):
    rng = np.random.default_rng(radius)
    for size, dtype in ((64, np.float64), (400, np.float32), (257, np.float32)):
        nodes = rng.uniform(-0.05, 1.05, (30, 2)).astype(dtype)
        edges = rng.integers(0, 30, (45, 2))
        want = jrasterize_graph(nodes, edges, size, radius)
        got = rasterize_graph(nodes, edges, size, radius)
        assert got.dtype == np.uint8 and got.shape == (size, size, 3)
        np.testing.assert_array_equal(got, want)
        assert want.max() == 255


def _record(rng, img_path, smd):
    def graph(n):
        return rng.uniform(0, 1, (n, 2)).astype(np.float32), rng.integers(0, n, (n + 5, 2))

    pred_nodes, pred_edges = graph(int(rng.integers(5, 25)))
    gt_nodes, gt_edges = graph(int(rng.integers(5, 25)))
    return dict(img_path=img_path, pred_nodes=pred_nodes, pred_edges=pred_edges,
                gt_nodes=gt_nodes, gt_edges=gt_edges, smd=smd)


def _drawn(record, size=512):
    """The pixels the pair overlay draws: both graphs over a black tile."""
    black = np.zeros((size, size, 3), np.uint8)
    return np.concatenate([jviz(black.copy(), record["pred_nodes"], record["pred_edges"]),
                           jviz(black.copy(), record["gt_nodes"], record["gt_edges"])],
                          axis=1).any(-1)


def _assert_overlay(got, want, drawn):
    assert got.shape == want.shape == (512, 1024, 3) and got.dtype == np.uint8
    assert drawn.any()
    np.testing.assert_array_equal(got[drawn], want[drawn])
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.fixture(scope="module")
def spacenet(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("triage"))
    split = make_spacenet_fixture(root, image_size=400, n_train=2, n_val=1, n_test=2, spacing=60)
    return root, split


def test_visualize_pred_gt_pair_matches_jax(spacenet):
    root, split = spacenet
    rng = np.random.default_rng(1)
    for name in split["test"]:
        path = os.path.join(root, "spacenet", "RGB_1.0_meter", f"{name}__rgb.png")
        record = _record(rng, path, 0.1)
        _assert_overlay(visualize_pred_gt_pair(record), jpair(record), _drawn(record))


def test_triage_cli_matches_jax(spacenet, tmp_path):
    root, split = spacenet
    rng = np.random.default_rng(2)
    names = split["train"] + split["validation"] + split["test"]
    records = [_record(rng, os.path.join(root, "spacenet", "RGB_1.0_meter", f"{n}__rgb.png"),
                       float(s)) for n, s in zip(names * 2, rng.uniform(0, 0.2, 2 * len(names)))]
    results = str(tmp_path / "inference_results.pickle")
    with open(results, "wb") as f:
        pickle.dump(records, f)
    jout, out = str(tmp_path / "jax"), str(tmp_path / "port")
    args = ["--results", results, "--sample_num", "4", "--smd_threshold", "0.05"]
    random.seed(0)
    jtriage.main(args + ["--output_dir", jout])
    random.seed(0)
    paths = triage.main(args + ["--output_dir", out])
    files = sorted(os.listdir(jout))
    assert sorted(os.listdir(out)) == files and len(files) == 4
    assert [os.path.basename(p) for p in paths] == sorted(files, reverse=True, key=lambda f:
                                                          float(f.split("_")[1]))
    by_name = {f"smd_{r['smd']:.6f}_{os.path.basename(r['img_path'])}": r for r in records}
    for name in files:
        want = cv2.imread(os.path.join(jout, name))
        got = read_png(os.path.join(out, name))[..., ::-1]
        _assert_overlay(got, want, _drawn(by_name[name]))


def test_debug_labels_cli_matches_jax(spacenet, tmp_path):
    _load_jax_native()
    root, _ = spacenet
    values = read_flat_yaml(os.path.join(REPO, "configs", "toponet_vitb_256_spacenet.yaml"))
    values.update(TOPO_SAMPLE_NUM=16, MAX_NEIGHBOR_QUERIES=8)
    cfg = str(tmp_path / "cfg.yaml")
    write_flat_yaml(cfg, values)
    jout, out = str(tmp_path / "jax"), str(tmp_path / "port")
    args = ["--config", cfg, "--data_root", root, "--num", "6", "--seed", "3", "--tile", "1"]
    jdebug_labels.main(args + ["--out", jout])
    paths = debug_labels.main(args + ["--out", out])
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout)) == sorted(
        f"viz_{i}.png" for i in range(6))
    assert [os.path.basename(p) for p in paths] == [f"viz_{i}.png" for i in range(6)]
    drawn = 0
    for i in range(6):
        want = cv2.imread(os.path.join(jout, f"viz_{i}.png"))
        got = read_png(os.path.join(out, f"viz_{i}.png"))[..., ::-1]
        np.testing.assert_array_equal(got, want)
        drawn += int((got == 255).all(-1).sum())
    assert drawn  # connected pairs drew white lines
