"""The per-layer metrics that read the engine's own spans and counter
(last_timings' p1_dispatch, mask_wait, p1_device, p2_dispatch, p2_fetch,
aggregate, launches), on the tiny CPU cell: each reads a number but
phase1_s.region (CUDA events: None here) and launches.region (0: the plain
versions run); and a region's launches count once under infer_tiles."""

from __future__ import annotations

import pytest
import torch

from benchmark import cells, run

NEW = ("p1_dispatch_s.region", "mask_wait_s.region", "phase1_s.region", "p2_dispatch_s.region",
       "p2_fetch_s.region", "agg_s.region", "launches.region")
SECONDS = ("p1_dispatch_s.region", "mask_wait_s.region", "p2_dispatch_s.region",
           "p2_fetch_s.region", "agg_s.region")


@pytest.fixture
def stub_launches(monkeypatch):
    """One launch a phase-1 batch and one a phase-2 dispatch, counted as a
    kernel wrapper counts."""
    from sam_road_tpu_torch.inference.engine import TiledInferenceEngine
    from sam_road_tpu_torch.ops import _build

    for name in ("_phase1_batch", "_scores_q"):
        original = getattr(TiledInferenceEngine, name)

        def launch(self, *args, _original=original):
            _build.launches["stub"] += 1
            return _original(self, *args)

        monkeypatch.setattr(TiledInferenceEngine, name, launch)
    _build.launches.clear()
    yield _build.launches
    _build.launches.clear()


def test_new_metrics_read_the_tiny_region_run(tiny):
    spec, root = tiny
    assert {m["name"] for m in run.metrics_of(spec, "region.vitb_512", True)} >= set(NEW)
    result, _, _ = run.execute(spec, "region.vitb_512", 2 ** 31 + 23, 0.5, True,
                               torch.device("cpu"), root=root)
    got = result["metrics"]
    assert "phase1_s.region" not in got  # no CUDA events on the CPU
    assert got["launches.region"] == {"value": 0.0, "unit": "count"}
    for name in SECONDS:
        assert got[name]["unit"] == "s" and got[name]["value"] >= 0.0, name
    assert got["p1_dispatch_s.region"]["value"] > 0.0 and got["agg_s.region"]["value"] > 0.0
    assert result["correct"]


def test_readers_need_the_program_keys():
    """A program without the keys (the parent of these metrics) reads
    None, not an error; phase 2's keys count 0 for a region without
    vertices, as p2_build does."""
    old = {"phase1": 1.0, "extract": 0.5, "phase2": 0.2, "total": 1.7, "p2_build": 0.1,
           "p2_dispatch": 0.05, "p2_fetch": 0.01}
    region = {"kind": "region", "timings": [old, {"phase1": 1.0, "extract": 0.1,
                                                  "phase2": 0.0}]}
    for name in NEW:
        value = run.reader(name)(region)
        if name in ("p2_dispatch_s.region", "p2_fetch_s.region"):
            assert value == pytest.approx(old[name.split("_s.")[0]] / 2)
        else:
            assert value is None, name
    assert all(run.reader(name)({"kind": "train"}) is None for name in NEW)


def test_launches_count_each_region_once(tiny, stub_launches):
    """Under infer_tiles region i + 1's phase 1 runs before region i's
    _finish; each region's launches are still its own: its two phase-1
    batches and its phase-2 dispatches, the same on every lap."""
    spec, root = tiny
    work = next(w for w in spec["workloads"] if w["name"] == "region.vitb_512")
    config = run.read_json(next(c for c in spec["configs"] if c["name"] == work["config"])["file"],
                           root)
    mix = run.read_json(f"benchmark/traffic/{work['traffic']}.json", root)
    got = cells.region(config, mix, 2 ** 31 + 29, 0.3, False, torch.device("cpu"), 0.0)
    per_region = [t["launches"] for t in got["timings"]]
    n_batches = 2  # 16 patches in batches of 8
    assert all(n_batches < k <= 2 * n_batches for k in per_region), per_region
    # each region of the window is one of the mix's: the same region, the
    # same count, wherever it lies in the pipeline
    n = len(got["regions"])
    for j, k in enumerate(per_region):
        assert k == per_region[j % n]
    assert run.reader("launches.region")(got) == pytest.approx(sum(per_region) / len(per_region))
