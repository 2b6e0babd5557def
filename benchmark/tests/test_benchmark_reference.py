"""The plain reference against the program on the CPU at a tiny size, in
float32: the weights load by name, the host layers agree exactly, and a
whole run of each cell reads (near) zero on every number it compares."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.reference import model, region as ref_region

from test_benchmark_counts import TINY, VITB, VITH


@pytest.mark.parametrize("arch,version", [(TINY, None), (VITB, "vit_b"), (VITH, "vit_h")],
                         ids=["tiny", "vit_b", "vit_h"])
def test_state_dict_matches_the_program(arch, version):
    from sam_road_tpu_torch.models.sam_road import SAMRoad

    if version is None:
        return
    with torch.device("meta"):
        net = SAMRoad(version, arch["PATCH_SIZE"])
    want = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    got = {n: tuple(s) for n, s, _ in model.param_specs(arch)}
    assert got == want


@pytest.mark.parametrize("scale", [1.0, 0.3, 100.0])
def test_nms_equals_the_program(scale):
    from sam_road_tpu_torch.graph.nms import nms_points

    rng = np.random.default_rng(0)
    pts = rng.integers(0, 300, (20000, 2)).astype(float)
    scores = rng.integers(0, 3, 20000) * scale
    want = nms_points(pts, scores, 8)
    got = ref_region.nms(pts, scores, 8)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_patch_pairs_equal_the_program():
    from sam_road_tpu_torch.inference.pairs import build_pairs_for_boxes

    rng = np.random.default_rng(1)
    verts = rng.integers(0, 2048, (9000, 2)).astype(np.float64)
    boxes = np.array([[100, 200, 612, 712], [0, 0, 512, 512], [1500, 1500, 2012, 2012]], float)
    for box, (pidx, pts, pairs, valid) in zip(boxes, build_pairs_for_boxes(verts, boxes, 16, 64.0)):
        ids, local, nbr, ok = ref_region.patch_pairs(verts, box, 16, 64.0)
        assert np.array_equal(ids, pidx) and np.array_equal(local, pts)
        assert np.array_equal(ok, valid) and np.array_equal(nbr[ok], pairs[..., 1][valid])


def test_region_cell_agrees(tiny):
    spec, root = tiny
    result, _, numbers = run.execute(spec, "region.vitb_512", 2 ** 31 + 17, 0.5, False,
                                     torch.device("cpu"), root=root)
    assert numbers["vertex_mismatch"] == 0 and numbers["edge_mismatch"] == 0
    assert numbers["mask_gap"] <= 1 and numbers["score_patch_gap"] < 1e-4
    assert result["correct"] and result["attempted"] >= 1


def test_train_cell_agrees(tiny):
    spec, root = tiny
    result, _, numbers = run.execute(spec, "train.vith_256", 2 ** 31 + 18, 0.5, False,
                                     torch.device("cpu"), root=root)
    assert numbers["loss_gap"] < 1e-5 and numbers["grad_norm_gap"] < 1e-5
    assert numbers["grad_leaf_gap"] < 1e-4 and numbers["skipped"] == 0
    assert result["correct"]
