"""The port's spans (utils/profiling.py::span) and the engine's and the
training step's timings built on them, on the CPU: a span times its block
and is a profiler range only while a profiler runs; under infer_tiles a
region's phase1 and total hold its own time only; every documented span
name lies in a profile of infer_tiles and of train_epoch; each step's aux
carries wait_seconds; a region's launches count once."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sam_road_tpu_torch import config
from sam_road_tpu_torch.inference import engine as engine_mod
from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random
from sam_road_tpu_torch.ops import _build
from sam_road_tpu_torch.training import harness
from sam_road_tpu_torch.utils import profiling
from sam_road_tpu_torch.utils.profiling import span

# vit_t at 64 px patches, a 192 px region: 16 patches in two streamed bands
# of batch 8
ENGINE = dict(SAM_VERSION="vit_t", PATCH_SIZE=64, INFER_BATCH_SIZE=8, INFER_PATCHES_PER_EDGE=4,
              SAMPLE_MARGIN=8, COMPUTE_DTYPE="float32", ITSC_NMS_RADIUS=4, ROAD_NMS_RADIUS=8,
              NEIGHBOR_RADIUS=24, MAX_NEIGHBOR_QUERIES=4, TOPO_THRESHOLD=0.5)
TRAIN = dict(SAM_VERSION="vit_t", PATCH_SIZE=64, COMPUTE_DTYPE="float32", TOPO_SAMPLE_NUM=4,
             MAX_NEIGHBOR_QUERIES=4, BATCH_SIZE=2, BASE_LR=1e-3)
ENGINE_SPANS = ("engine.phase1", "engine.fetch_masks", "engine.extract", "extract.threshold",
                "extract.nms_keypoint", "extract.nms_road", "extract.nms_final",
                "engine.phase2", "engine.p2.build", "pairs.knn", "pairs.pack",
                "engine.p2.dispatch", "engine.p2.fetch", "engine.p2.collect",
                "engine.aggregate", "aggregate.unique", "aggregate.sums")
SPEC_SPANS = ("engine.spec", "engine.spec.wait", "engine.spec.extract")
TRAIN_SPANS = ("train.data", "train.materialize", "train.forward", "train.backward",
               "train.grad_norm", "train.finite_sync", "train.update", "train.aux_sync",
               "train.release")


@pytest.fixture(scope="module")
def model():
    return init_random(SAMRoad.from_config(config.load_config(overrides=ENGINE)), 0)


@pytest.fixture(scope="module")
def regions():
    r = np.random.default_rng(7)
    return [r.integers(0, 255, (192, 192, 3), dtype=np.uint8) for _ in range(3)]


@pytest.fixture(scope="module")
def thresholds(model, regions):
    """The benchmark's calibration: masks at thresholds 1.0 (no vertex),
    then their 0.99 / 0.92 quantiles."""
    engine = _engine(model, dict(ITSC_THRESHOLD=1.0, ROAD_THRESHOLD=1.0))
    _, _, kp, road = engine.infer_one_img(regions[0])
    assert engine.last_timings["phase2"] == 0.0 and "total" not in engine.last_timings
    return dict(ITSC_THRESHOLD=float(np.quantile(kp / 255.0, 0.99)),
                ROAD_THRESHOLD=float(np.quantile(road / 255.0, 0.92)))


def _engine(model, over=None):
    return engine_mod.TiledInferenceEngine(config.load_config(overrides={**ENGINE, **(over or {})}),
                                           model, "cpu", point_bucket=16)


def _names(prof) -> list:
    return [e.name for e in prof.events()]


def test_span_off_adds_into_its_dict_and_opens_no_range(monkeypatch):
    opened = []
    record_function = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or record_function(name))
    into = {"a": 1.0}
    with span("x", into, "a") as s:
        time.sleep(0.01)
    with span("x", into, "b"):
        pass
    assert not opened and not profiling._profiling()
    assert s.seconds >= 0.01 and into["a"] == pytest.approx(1.0 + s.seconds)
    assert set(into) == {"a", "b"} and into["b"] >= 0.0
    with profile(activities=[ProfilerActivity.CPU]):
        with span("y"):
            pass
    assert opened == ["y"]


def test_span_on_nests_under_its_parent():
    into = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("test.outer", into, "outer"):
            with span("test.inner"):
                torch.ones(4).add_(1)
    by_name = {e.name: e for e in prof.events()}
    outer, inner = by_name["test.outer"], by_name["test.inner"]
    assert inner.cpu_parent is outer
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    assert into["outer"] > 0.0


def test_infer_tiles_phase1_is_the_regions_own(model, regions, thresholds, monkeypatch):
    """Extraction slowed by 0.2 s: region 2's phase 1 is dispatched before
    region 1's host half, whose extraction the old timer (from region 2's
    _run_phase1 to its masks on the host) took in; phase1 is region 2's
    own dispatch and wait alone."""
    engine = _engine(model, thresholds)
    extract = engine_mod.extract_graph_points

    def slow(*args):
        time.sleep(0.2)
        return extract(*args)

    monkeypatch.setattr(engine_mod, "extract_graph_points", slow)
    own, starts, fetched = [], [], []
    run_phase1, fetch_masks = engine._run_phase1, engine._fetch_masks

    def phase1(img):
        starts.append(time.perf_counter())
        p1 = run_phase1(img)
        own.append(time.perf_counter() - starts[-1])
        return p1

    def fetch(p1):
        t0 = time.perf_counter()
        masks = fetch_masks(p1)
        fetched.append(time.perf_counter())
        own[len(fetched) - 1] += fetched[-1] - t0
        return masks

    engine._run_phase1, engine._fetch_masks = phase1, fetch
    timings = []
    for out in engine.infer_tiles(regions[:2]):
        assert out[0].shape[0] > 0 and out[1].shape[0] > 0, "the regions must have edges"
        timings.append(dict(engine.last_timings))
    old_phase1 = fetched[1] - starts[1]
    assert old_phase1 - timings[1]["phase1"] > 0.2
    for t, mine in zip(timings, own):
        assert abs(t["phase1"] - mine) < 0.01 + 0.05 * mine
        assert t["phase1"] == pytest.approx(t["p1_dispatch"] + t["mask_wait"])
        assert t["extract"] >= 0.2
        parts = t["phase1"] + t["extract"] + t["phase2"] + t["aggregate"]
        assert abs(t["total"] - parts) < 1e-3
        assert t["phase2"] >= t["p2_build"] + t["p2_dispatch"] + t["p2_fetch"] - 1e-3
        assert t["launches"] == 0  # the CPU runs the plain versions
        assert "p1_device" not in t


def test_infer_one_img_total_is_the_call(model, regions, thresholds):
    """Where nothing interleaves, total is the host's time of the call, as
    the JAX engine's total."""
    engine = _engine(model, thresholds)
    t0 = time.perf_counter()
    engine.infer_one_img(regions[0])
    wall = time.perf_counter() - t0
    t = engine.last_timings
    assert t["total"] <= wall and t["total"] > 0.9 * wall - 2e-3


def test_launches_count_a_region_once_under_infer_tiles(model, regions, thresholds):
    """A stub launch wrapper counts one launch a phase-1 batch and one a
    phase-2 dispatch; region i + 1's phase 1 runs before region i's
    _finish, and each region still counts only its own."""
    engine = _engine(model, thresholds)
    phase1_batch, scores_q = engine._phase1_batch, engine._scores_q

    def counted(fn):
        def launch(*args):
            _build.launches["stub"] += 1
            return fn(*args)
        return launch

    engine._phase1_batch, engine._scores_q = counted(phase1_batch), counted(scores_q)
    alone = []
    for img in regions:
        _build.launches.clear()
        engine.infer_one_img(img)
        alone.append(engine.last_timings["launches"])
        assert alone[-1] == _build.launches.total() > 2
    _build.launches.clear()
    tiled = [dict(engine.last_timings)["launches"] for _ in engine.infer_tiles(regions)]
    assert tiled == alone and sum(tiled) == _build.launches.total()
    _build.launches.clear()


def test_every_engine_span_is_in_a_profile_of_infer_tiles(model, regions, thresholds):
    plain = _engine(model, thresholds)
    spec = _engine(model, dict(thresholds, INFER_P2_SPECULATIVE=True))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        list(plain.infer_tiles(regions[:2]))
        spec.infer_one_img(regions[0])
    names = set(_names(prof))
    assert set(ENGINE_SPANS + SPEC_SPANS) <= names, set(ENGINE_SPANS + SPEC_SPANS) - names
    assert "spec_s" in spec.last_timings


def _batches(n):
    r = np.random.default_rng(5)
    return [{"rgb": r.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8),
             "keypoint_mask": (r.random((2, 64, 64)) < 0.1).astype(np.uint8) * 255,
             "road_mask": (r.random((2, 64, 64)) < 0.3).astype(np.uint8) * 255,
             "graph_points": r.uniform(0, 64, (2, 16, 2)).astype(np.float32),
             "pairs": r.integers(0, 16, (2, 4, 4, 2)).astype(np.int32),
             "connected": r.random((2, 4, 4)) < 0.4, "valid": r.random((2, 4, 4)) < 0.7}
            for _ in range(n)]


def test_train_epoch_spans_and_wait_seconds(tmp_path):
    cfg = config.load_config(overrides=TRAIN)
    model = init_random(SAMRoad.from_config(cfg), 1)
    trainer = harness.Trainer(cfg, model, str(tmp_path), steps_per_epoch=10, device="cpu",
                              log_every=1)
    trainer.train_epoch(_batches(1), 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_epoch(_batches(2), 1)
    names = _names(prof)
    for name in TRAIN_SPANS:
        # train.data: two batches and the loader's end
        assert names.count(name) == (3 if name == "train.data" else 2), name
    assert len(trainer.history) == 3
    for aux in trainer.history:
        assert 0.0 < aux["wait_seconds"] < aux["seconds"]
        assert 0.0 <= aux["data_seconds"] < aux["seconds"]
        assert np.isfinite(aux["loss"]) and aux["skipped"] == 0.0
