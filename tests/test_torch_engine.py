"""The port's host modules and engine against the JAX package on the CPU.

Host code (patch grid, vertex extraction, pair building, config defaults)
must match exactly. The engine runs the SKILL.md known-good geometry (vit_t,
64 px patches, a 192 px region, batch 8, fp32, FUSED_ENCODER on) against the
JAX engine with the same weights through the bridge: fused masks within 1
uint8 level, vertex counts within 2 (the bound of
tests/test_fast_encoder.py's engine test), edge-set Jaccard >= 0.95
(observed 1.0: identical graphs).

Every comparison with the JAX host code runs against its native C++ path
(_load_jax_native): with a silent scipy fallback the JAX side would break
nearest-k distance ties differently.
"""

import os
import shutil
import time

import numpy as np
import pytest

import jax

from sam_road_tpu import config as jconfig
from sam_road_tpu.graph import nms as jnms_module
from sam_road_tpu.inference import pairs as jpairs_module
from sam_road_tpu.data.partitions import get_patch_info_one_img as jpatch_info
from sam_road_tpu.graph.extraction import extract_graph_points as jextract
from sam_road_tpu.graph.nms import nms_points as jnms
from sam_road_tpu.inference.engine import TiledInferenceEngine as JEngine
from sam_road_tpu.inference.pairs import build_pairs_for_boxes as jpairs
from sam_road_tpu.models.sam_road import init_params
from sam_road_tpu_torch import config
from sam_road_tpu_torch.data.partitions import get_patch_info_one_img
from sam_road_tpu_torch.graph.extraction import extract_graph_points
from sam_road_tpu_torch.graph.nms import nms_points
from sam_road_tpu_torch.inference.engine import TIMING_KEYS, TiledInferenceEngine
from sam_road_tpu_torch.inference.pairs import build_pairs_for_boxes
from sam_road_tpu_torch.models.convert import load_flax_params
from sam_road_tpu_torch.models.sam_road import SAMRoad

ENGINE = dict(
    SAM_VERSION="vit_t", PATCH_SIZE=64, INFER_BATCH_SIZE=8, INFER_PATCHES_PER_EDGE=4,
    SAMPLE_MARGIN=8, COMPUTE_DTYPE="float32", ITSC_THRESHOLD=0.9, ROAD_THRESHOLD=0.45,
    TOPO_THRESHOLD=0.4, ITSC_NMS_RADIUS=4, ROAD_NMS_RADIUS=8, NEIGHBOR_RADIUS=24,
    MAX_NEIGHBOR_QUERIES=4, FUSED_ENCODER=True,
)


def _load_jax_native(attempts: int = 20, pause: float = 0.25):
    """Load the JAX package's native NMS and pairs libraries, retrying.

    Both build straight into the shared native/build/lib*.so with a
    non-atomic `g++ -o`. Test workers that import them at once (this file,
    tests/test_pairs_native.py, tests/test_inference_engine.py) can load a
    half-written file; the JAX loader swallows that failure and stays on its
    scipy fallback for the rest of the process. So while g++ exists and a
    load fails, clear the module's tried flag and load again, then require
    both."""
    if shutil.which("g++") is None:
        return
    for module in (jnms_module, jpairs_module):
        for _ in range(attempts):
            if module._load_native() is not None:
                break
            module._NATIVE_TRIED = False
            time.sleep(pause)
        assert module._load_native() is not None, f"{module.__name__} native library"


@pytest.fixture(autouse=True, scope="module")
def jax_native():
    _load_jax_native()


def test_load_jax_native_recovers_from_a_failed_load(monkeypatch):
    """A load that failed once (the state a half-written library leaves)
    is retried until the library loads."""
    for module in (jnms_module, jpairs_module):
        monkeypatch.setattr(module, "_NATIVE", None)
        monkeypatch.setattr(module, "_NATIVE_TRIED", True)
    _load_jax_native(pause=0.0)
    assert jnms_module._NATIVE is not None and jpairs_module._NATIVE is not None


def test_config_defaults_match_jax_package_key_for_key():
    assert list(config.DEFAULTS) == list(jconfig.DEFAULTS)
    assert config.DEFAULTS == jconfig.DEFAULTS
    cfg = config.load_config(overrides={"PATCH_SIZE": 64})
    assert cfg.PATCH_SIZE == 64 and not cfg.NOT_A_KEY


def test_config_reads_yaml_like_jax_package():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "toponet_vitb_512_cityscale.yaml")
    assert config.load_config(path) == jconfig.load_config(path)


@pytest.mark.parametrize("args", [(0, 2048, 64, 512, 16), (3, 192, 8, 64, 4), (1, 100, 0, 50, 3)])
def test_patch_grid_matches(args):
    assert get_patch_info_one_img(*args) == jpatch_info(*args)


def _masks(seed, size=160):
    r = np.random.default_rng(seed)
    kp = (r.random((size, size)) ** 6 * 255).astype(np.uint8)
    road = (r.random((size, size)) ** 3 * 255).astype(np.uint8)
    return kp, road


def test_nms_matches_with_indices():
    r = np.random.default_rng(1)
    pts = r.uniform(0, 200, size=(3000, 2))
    scores = r.random(3000) * 1.5  # some above 1.0: immune to suppression
    got_p, got_i = nms_points(pts, scores, 6.0, return_indices=True)
    want_p, want_i = jnms(pts, scores, 6.0, return_indices=True)
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(got_i, want_i)


def test_extract_graph_points_matches():
    kp, road = _masks(2)
    cfg = config.load_config(overrides=ENGINE)
    got = extract_graph_points(kp, road, cfg)
    want = jextract(kp, road, jconfig.load_config(overrides=ENGINE))
    assert got.shape[0] > 10
    np.testing.assert_array_equal(got, want)


def test_build_pairs_for_boxes_matches():
    r = np.random.default_rng(3)
    pts = r.integers(0, 192, size=(400, 2)).astype(np.float64)
    boxes = np.array([[8, 8, 72, 72], [50, 60, 114, 124], [0, 0, -1, -1], [128, 128, 192, 192]],
                     np.float64)
    got = build_pairs_for_boxes(pts, boxes, 4, 24.0, cap=16)  # cap forces the retry
    want = jpairs(pts, boxes, 4, 24.0, cap=16)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    empty = build_pairs_for_boxes(np.zeros((0, 2)), boxes, 4, 24.0)
    assert all(e[0].shape == (0,) for e in empty)


@pytest.fixture(scope="module")
def engines():
    params = jax.tree.map(np.asarray, jax.jit(
        lambda: init_params(jconfig.load_config(overrides=ENGINE)))())
    jeng = JEngine(jconfig.load_config(overrides=ENGINE), params, point_bucket=16)
    model = load_flax_params(SAMRoad.from_config(config.load_config(overrides=ENGINE)), params)
    teng = TiledInferenceEngine(config.load_config(overrides=ENGINE), model, "cpu",
                                point_bucket=16)
    return jeng, teng


def _edge_set(nodes, edges):
    return {tuple(sorted((tuple(nodes[a]), tuple(nodes[b])))) for a, b in edges}


def test_engine_matches_jax_engine(engines):
    jeng, teng = engines
    img = np.random.default_rng(3).integers(0, 255, (192, 192, 3), dtype=np.uint8)
    n0, e0, kp0, road0 = jeng.infer_one_img(img)
    n1, e1, kp1, road1 = teng.infer_one_img(img)
    assert kp1.shape == road1.shape == (192, 192) and kp1.dtype == np.uint8
    assert np.abs(kp0.astype(int) - kp1.astype(int)).max() <= 1
    assert np.abs(road0.astype(int) - road1.astype(int)).max() <= 1
    assert abs(n0.shape[0] - n1.shape[0]) <= 2
    s0, s1 = _edge_set(n0, e0), _edge_set(n1, e1)
    assert len(s0) > 50
    assert len(s0 & s1) / len(s0 | s1) >= 0.95
    # every JAX key, and beyond them exactly the port's (p1_device on CUDA alone)
    assert set(jeng.last_timings) <= set(teng.last_timings)
    assert set(teng.last_timings) - set(jeng.last_timings) == set(TIMING_KEYS) - {"p1_device"}


def test_engine_infer_tiles_matches_one_by_one(engines):
    _, teng = engines
    r = np.random.default_rng(4)
    imgs = [r.integers(0, 255, (192, 192, 3), dtype=np.uint8) for _ in range(2)]
    tiled = list(teng.infer_tiles(imgs))
    assert len(tiled) == 2
    for img, got in zip(imgs, tiled):
        want = teng.infer_one_img(img)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_engine_counts_nms_points(engines):
    """last_timings' NMS counters: uint8 mask values are all above 1.0, so
    the keypoint and road passes put no candidate into the grid and the
    final pass puts in all of its input, every candidate of both."""
    _, teng = engines
    img = np.random.default_rng(5).integers(0, 255, (192, 192, 3), dtype=np.uint8)
    _, _, kp, road = teng.infer_one_img(img)
    t = teng.last_timings
    first = int((kp > ENGINE["ITSC_THRESHOLD"] * 255).sum()
                + (road > ENGINE["ROAD_THRESHOLD"] * 255).sum())
    assert first > 100
    assert t["nms_suppressible"] == first
    assert t["nms_candidates"] == 2 * first


def test_engine_rejects_bad_regions(engines):
    _, teng = engines
    with pytest.raises(ValueError):
        teng.infer_one_img(np.zeros((192, 128, 3), np.uint8))
    with pytest.raises(TypeError):
        teng.infer_one_img(np.zeros((192, 192, 3), np.float32))
