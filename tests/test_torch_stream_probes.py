"""The streamed-schedule probes (sam_road_tpu_torch/tools/probe_stream_sched.py
and probe_band_overhead.py) on the CPU, at tests/test_torch_engine.py's
ENGINE geometry (vit_t, 64 px patches, batch 8, a 192 px region, JAX
init_params weights carried across), where `_stream_plan` splits the 4 x 4
patch grid into 2 bands.

The replay's nodes, edges and masks equal `infer_one_img`'s bit for bit,
and the whole-region path's; the bands' chained masks equal the whole
path's; each JSON line carries the JAX tools' keys with one entry a band in
each list, the host times in order.
"""

import json

import numpy as np
import pytest
import torch

from sam_road_tpu_torch.tools import bench, probe_band_overhead, probe_stream_sched
from test_torch_bench_tools import _last_json, flax_params, img, model  # noqa: F401
from test_torch_engine import ENGINE

# the JAX tools' keys: tools/probe_stream_sched.py's record and line,
# tools/probe_band_overhead.py's line
SCHED_RECORD = ("slab_disp", "slab_ready", "band_disp", "chunk_ready", "fetch_done",
                "seg_slice_s", "p1_wall", "engine_timings", "total")
# the port's record adds the host's waits for the slabs (the serial upload)
PORT_RECORD = SCHED_RECORD + ("slab_wait_s",)
SCHED_LINE = ("round", "plain_total", "plain_timings", "instr")
OVERHEAD_LINE = ("round", "whole", "whole2", "bands_total", "bands_async", "per_band",
                 "overhead_async_vs_mean_whole")


def _engine(model, over=None):
    return bench.make_engine("cpu", {**ENGINE, **(over or {})}, model)


def test_the_geometry_streams_in_two_bands(model, img):
    engine = _engine(model)
    infos, plan = probe_stream_sched.stream_plan(engine, 192)
    assert len(infos) == 16 and [(b["i0"], b["i1"]) for b in plan] == [(0, 8), (8, 16)]
    whole = _engine(model, {"INFER_STREAM_PHASE1": False})
    with pytest.raises(ValueError, match="does not stream"):
        probe_stream_sched.stream_plan(whole, 192)


def test_instrumented_run_equals_infer_one_img_and_the_whole_path(model, img):
    engine = _engine(model)
    whole = _engine(model, {"INFER_STREAM_PHASE1": False})
    bench.calibrate(engine, img, whole)
    with torch.no_grad():
        want = engine.infer_one_img(img)
        rec, got = probe_stream_sched.instrumented_run(engine, img)
        ref = whole.infer_one_img(img)
    assert want[0].shape[0] > 10 and want[1].shape[0] > 10
    assert probe_stream_sched.same_outputs(want, got)
    assert probe_stream_sched.same_outputs(ref, got)
    assert set(rec) == set(PORT_RECORD)
    assert rec["engine_timings"] == engine.last_timings


def test_probe_stream_sched_prints_a_line_a_round(model, img, capsys):
    rows = probe_stream_sched.main("cpu", rounds=2, model=model, overrides=ENGINE, region=img)
    assert _last_json(capsys) == json.loads(json.dumps(rows[-1]))
    assert [r["round"] for r in rows] == [0, 1]
    for row in rows:
        assert set(SCHED_LINE) <= set(row) and row["same_outputs"]
        rec = row["instr"]
        assert set(rec) == set(PORT_RECORD)
        for key in ("slab_disp", "slab_ready", "band_disp", "chunk_ready", "fetch_done",
                    "seg_slice_s", "slab_wait_s"):
            assert len(rec[key]) == 2, key
            assert all(np.isfinite(v) and v >= 0 for v in rec[key]), key
        for key in ("band_disp", "fetch_done", "chunk_ready", "slab_disp"):
            assert rec[key] == sorted(rec[key]), key
        assert rec["band_disp"][-1] <= rec["fetch_done"][0] <= rec["p1_wall"] <= rec["total"]
        assert {"phase1", "extract", "phase2", "total"} <= set(rec["engine_timings"])
        assert row["plain_total"] > 0 and "phase1" in row["plain_timings"]
        assert row["bands"] == [[0, 109], [83, 192]]


@pytest.mark.parametrize("over", [{}, {"INFER_STREAM_SERIAL_UPLOAD": False},
                                  {"INFER_P2_SPECULATIVE": True}],
                         ids=["serial_upload", "concurrent_upload", "speculative"])
def test_instrumented_run_times_the_engines_own_schedule(model, img, over):
    """The record follows the config's schedule: under the serial upload
    (the default) slab 1 is sent after band 0 is dispatched, and the host
    waits for each slab; without it both slabs go before band 0 and no wait
    is timed. Every chunk read is timed, speculation's too, and the engine
    keeps none of the probe's wrappers."""
    engine = _engine(model, over)
    bench.calibrate(engine, img)
    with torch.no_grad():
        want = engine.infer_one_img(img)
        rec, got = probe_stream_sched.instrumented_run(engine, img)
    assert probe_stream_sched.same_outputs(want, got)
    if over.get("INFER_STREAM_SERIAL_UPLOAD", True):
        assert rec["band_disp"][0] <= rec["slab_disp"][1] <= rec["band_disp"][1]
    else:
        assert rec["slab_disp"][1] <= rec["band_disp"][0] and rec["slab_wait_s"] == [0.0, 0.0]
    assert len(rec["fetch_done"]) == 2 and rec["p1_wall"] == rec["fetch_done"][-1]
    if "INFER_P2_SPECULATIVE" in over:
        assert "spec_dispatched" in rec["engine_timings"]
    assert not {"_band_pixels", "_stream_band", "_speculate_phase2"} & set(vars(engine))
    assert not {"put", "wait"} & set(vars(engine.uploads))


def test_probe_band_overhead_bands_equal_the_whole_path(model, img, capsys):
    rows = probe_band_overhead.main("cpu", rounds=2, model=model, overrides=ENGINE, region=img)
    assert _last_json(capsys) == json.loads(json.dumps(rows[-1]))
    for r, row in enumerate(rows):
        assert set(OVERHEAD_LINE) <= set(row) and row["round"] == r
        assert row["masks_equal"]
        assert len(row["per_band"]) == 2
        for key in ("whole", "whole2", "bands_total", "bands_async"):
            assert np.isfinite(row[key]) and row[key] > 0, key
        assert row["bands_total"] >= sum(row["per_band"])
        assert row["overhead_async_vs_mean_whole"] == pytest.approx(
            row["bands_async"] - (row["whole"] + row["whole2"]) / 2)


def test_phase1_region_is_the_whole_paths_batch_loop(model, img):
    """The whole path split into its upload and `_phase1_region` gives
    `_run_phase1`'s masks and features; the streamed path's chunks join to
    the same masks."""
    whole = _engine(model, {"INFER_STREAM_PHASE1": False})
    engine = _engine(model)
    infos, _ = probe_stream_sched.stream_plan(engine, 192)
    with torch.no_grad():
        batches, masks = whole._phase1_region(torch.from_numpy(img), infos)
        want = whole._run_phase1(img)
        streamed = engine._run_phase1(img)
    assert len(want["masks"]) == 1 and torch.equal(masks, want["masks"][0])
    assert all(torch.equal(f, w) for (f, _), (w, _) in zip(batches, want["batches"],
                                                           strict=True))
    assert len(streamed["masks"]) == 2 and torch.equal(torch.cat(streamed["masks"], dim=1),
                                                        masks)
