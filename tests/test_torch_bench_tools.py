"""The port's inference measurement tools (sam_road_tpu_torch/tools/: bench,
profile_phase1, profile_extract_p2, profile_phase2, abtest_engine,
experiment_infer_batch, profile_encoder, experiment_fused_encoder) on the
CPU, at tests/test_torch_engine.py's ENGINE geometry (vit_t, 64 px patches,
a 192 px region, fp32): each runs small and returns its keys with finite,
positive times, and each split is held to the code it splits.

The whole slice: the bench tool's protocol (quantile thresholds from its
own masks, then `infer_one_img`) on JAX `init_params` weights carried
across gives the JAX engine's graph under bench.py's protocol, within
test_engine_matches_jax_engine's bounds (nodes within 2, edge-set Jaccard
>= 0.95) and thresholds within 1/255.
"""

import json
import math

import numpy as np
import pytest
import torch

import jax

from sam_road_tpu import config as jconfig
from sam_road_tpu.graph.extraction import extract_graph_points as jextract
from sam_road_tpu.inference.engine import TiledInferenceEngine as JEngine
from sam_road_tpu.models.sam_road import init_params
from sam_road_tpu.models.vit import Block as JBlock
from sam_road_tpu.ops.sampling import bilinear_sample_points as jsample
from sam_road_tpu_torch.config import load_config
from sam_road_tpu_torch.graph.extraction import extract_graph_points
from sam_road_tpu_torch.inference.engine import TIMING_KEYS, _accumulate, _finalize
from sam_road_tpu_torch.models import fast_encoder as fe
from sam_road_tpu_torch.models.convert import load_flax_params
from sam_road_tpu_torch.models.sam_road import SAMRoad
from sam_road_tpu_torch.models.vit import Block
from sam_road_tpu_torch.tools import (abtest_engine, bench, experiment_fused_encoder,
                                      experiment_infer_batch, profile_encoder,
                                      profile_extract_p2, profile_phase1, profile_phase2)
from test_torch_engine import ENGINE, _edge_set, _load_jax_native

SMALL_ENCODER = dict(batch=2, img_size=64, sam_version="vit_t")


@pytest.fixture(autouse=True, scope="module")
def jax_native():
    _load_jax_native()


@pytest.fixture(scope="module")
def flax_params():
    return jax.tree.map(np.asarray, jax.jit(
        lambda: init_params(jconfig.load_config(overrides=ENGINE)))())


@pytest.fixture(scope="module")
def model(flax_params):
    return load_flax_params(SAMRoad.from_config(load_config(overrides=ENGINE)), flax_params)


@pytest.fixture(scope="module")
def img():
    return np.random.default_rng(3).integers(0, 255, (192, 192, 3), dtype=np.uint8)


def _times_ok(result, exclude=()):
    """Every number under a key ending in _s, _ms or _rounds (lists too)
    finite and positive."""
    seen = []

    def walk(key, v):
        if isinstance(v, dict):
            for k, x in v.items():
                walk(k, x)
        elif isinstance(v, list):
            for x in v:
                walk(key, x)
        elif key.endswith(("_s", "_ms", "_rounds")) and key not in exclude:
            seen.append(v)
            assert math.isfinite(v) and v > 0, (key, v)

    walk("", result)
    assert seen


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bench_tool_matches_jax_engine_under_the_bench_protocol(flax_params, model, img):
    jeng = JEngine(jconfig.load_config(overrides=ENGINE), flax_params, point_bucket=16)
    _, _, kp, road = jeng.infer_one_img(img)
    jeng.config.ITSC_THRESHOLD = float(np.quantile(kp / 255.0, 0.99))
    jeng.config.ROAD_THRESHOLD = float(np.quantile(road / 255.0, 0.92))
    n0, e0, kp0, road0 = jeng.infer_one_img(img)

    result, (n1, e1, kp1, road1) = bench.run(bench.make_engine("cpu", ENGINE, model), img, 1)
    th = result["detail"]["thresholds"]
    assert abs(th["ITSC_THRESHOLD"] - jeng.config.ITSC_THRESHOLD) <= 1 / 255
    assert abs(th["ROAD_THRESHOLD"] - jeng.config.ROAD_THRESHOLD) <= 1 / 255
    assert np.abs(kp0.astype(int) - kp1.astype(int)).max() <= 1
    assert np.abs(road0.astype(int) - road1.astype(int)).max() <= 1
    assert abs(n0.shape[0] - n1.shape[0]) <= 2
    s0, s1 = _edge_set(n0, e0), _edge_set(n1, e1)
    assert len(s0) > 50
    assert len(s0 & s1) / len(s0 | s1) >= 0.95
    assert result["detail"]["nodes"] == n1.shape[0] and result["detail"]["edges"] == e1.shape[0]


def test_bench_main_prints_one_json_line_with_its_keys(model, img, capsys):
    result = bench.main("cpu", runs=2, model=model, overrides=ENGINE, region=img)
    assert _last_json(capsys) == json.loads(json.dumps(result))
    assert result["metric"] == "cityscale_2km_region_infer_s" and result["unit"] == "s"
    assert result["vs_baseline"] is None
    d = result["detail"]
    assert result["value"] == min(d["all_runs_s"]) and len(d["per_run"]) == 2
    assert d["median_s"] >= result["value"]
    # the JAX engine's keys and the port's own (p1_device on CUDA alone)
    assert set(d["timings"]) == {"phase1", "extract", "phase2", "total", "p2_build",
                                 "p2_dispatch", "p2_fetch", *TIMING_KEYS} - {"p1_device"}
    assert d["timings"] in d["per_run"]
    assert d["nodes"] > 0 and d["edges"] > 0 and d["patches"] == 16 and d["batch"] == 8
    assert d["tiles_per_sec"] == pytest.approx(16 / d["timings"]["phase1"])
    # CPU tensors take the plain versions: no launch, no device memory
    assert d["launches"] == {} and d["peak_mem_gib"] is None and d["device"] == "cpu"
    assert d["scores_finite"] and d["fused_encoder"]
    assert all(lo < hi for lo, hi in d["mask_levels"].values())
    assert d["mask_shape"] == [192, 192, 192, 192]
    _times_ok(result)


def test_tools_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        bench.main("cuda", runs=1)


@pytest.mark.parametrize("fused", [1, 0])
def test_profile_phase1_returns_every_stage(model, img, fused):
    res = profile_phase1.main("cpu", fused=fused, rounds=2, model=model, overrides=ENGINE,
                              region=img)
    assert res["batches"] == 2 and res["patches"] == 16 and res["fused"] == fused
    for name in profile_phase1.STAGES + ("upload", "mask_download"):
        assert len(res[name + "_s_rounds"]) == 2
        assert res[name + "_s"] == min(res[name + "_s_rounds"])
    assert res["mask_mib"] == 192 * 192 * 2 / 2 ** 20
    _times_ok(res)


def test_profile_phase1_stages_are_the_engines_phase1(model, img):
    """The crops equal the region's slices; the decoder stage's int32 masks,
    fused by the engine's _accumulate / _finalize, and the fusion stage are
    bit-equal to _run_phase1's masks."""
    engine = bench.make_engine("cpu", ENGINE, model)
    stages = profile_phase1.make_stages(engine, img, torch.from_numpy(img))
    origins = bench.batch_origins(engine, 192)
    p = engine.patch_size
    with torch.no_grad():
        crops, quants = stages["crop"](), stages["decoder"]()
        feats = stages["encoder"]()
        masks = stages["fusion"]()
        want = engine._run_phase1(img)
    for xy, crop in zip(origins, crops):
        ref = np.stack([img[y:y + p, x:x + p] for x, y in xy]).astype(np.float32)
        np.testing.assert_array_equal(crop.numpy(), ref)
    fused = torch.zeros((192, 192, 2), dtype=torch.int32)
    counter = torch.zeros((192, 192), dtype=torch.int32)
    for xy, q in zip(origins, quants):
        _accumulate(fused, counter, q, xy)
    assert torch.equal(_finalize(fused, counter), torch.cat(want["masks"], dim=1))
    assert all(torch.equal(c, w) for c, w in zip(masks, want["masks"], strict=True))
    for f, (wf, _) in zip(feats, want["batches"]):
        assert torch.equal(f, wf)


def test_extraction_split_gives_extract_graph_points(model, img):
    engine = bench.make_engine("cpu", ENGINE, model)
    bench.calibrate(engine, img)
    _, _, kp, road = engine.infer_one_img(img)
    row, final = profile_extract_p2.extraction_split(kp, road, engine.config)
    want = extract_graph_points(kp, road, engine.config)
    assert want.shape[0] > 50
    np.testing.assert_array_equal(final, want)
    jcfg = jconfig.load_config(overrides={**ENGINE, **{k: engine.config[k] for k in (
        "ITSC_THRESHOLD", "ROAD_THRESHOLD")}})
    np.testing.assert_array_equal(final, jextract(kp, road, jcfg))
    assert row["vertices"] == want.shape[0]
    assert row["kp_candidates"] >= row["kp_kept"] and row["road_candidates"] >= row["road_kept"]


def test_profile_extract_p2_main(model, img):
    res = profile_extract_p2.main("cpu", reps=2, model=model, overrides=ENGINE, region=img)
    assert len(res["extract"]) == len(res["phase2"]) == 2
    assert all(r["vertices"] == res["nodes"] for r in res["extract"])
    for r in res["phase2"]:
        assert r["edges"] == res["edges"] > 0 and r["batches"] == 2
        assert r["fetch_mb"] > 0
    # the CPU has no queue to drain
    _times_ok(res, exclude=("queue_drain_s",))


def test_profile_phase2_stages_are_the_engines_scoring(model):
    engine = bench.make_engine("cpu", ENGINE, model)
    inputs = profile_phase2.make_inputs(engine, 16)
    feats, points, pairs, valid = inputs
    assert feats.shape == (8, 4, 4, 256) and pairs.shape == (8, 16, 4, 2)
    assert 0.5 < valid.float().mean().item() < 0.7
    stages = profile_phase2.make_stages(engine, inputs)
    with torch.no_grad():
        sampled, scores, q = (stages[name]() for name in profile_phase2.STAGES)
        want = engine._scores_q(*profile_phase2.compact_inputs(engine, inputs))
    assert q.dtype == torch.int16 and torch.equal(q, want)
    assert torch.equal(q, torch.round(scores.float().clamp(-1, 1) * 32767).to(torch.int16))
    np.testing.assert_allclose(
        sampled.numpy(), np.asarray(jsample(feats.numpy(), points.numpy(), 64)), atol=1e-6)


def test_profile_phase2_main(model):
    res = profile_phase2.main(16, "cpu", iters=2, rounds=2, model=model, overrides=ENGINE)
    assert res["shape"] == {"B": 8, "S": 16, "P": 4}
    for name in profile_phase2.STAGES:
        assert res[name + "_ms"] == min(res[name + "_ms_rounds"])
    _times_ok(res)


def test_abtest_engine_a_equals_b_gives_identical_graphs(model, img):
    res = abtest_engine.main({}, 2, {}, "cpu", model=model, base=ENGINE, region=img)
    assert res["same_outputs"] and res["a_graph"] == res["b_graph"] and res["a_graph"][1] > 0
    assert len(res["a_s"]) == len(res["b_s"]) == len(res["paired_delta_a_minus_b"]) == 2
    assert res["paired_delta_a_minus_b"] == [a - b for a, b in zip(res["a_s"], res["b_s"])]
    _times_ok(res)


@pytest.mark.parametrize("b", [{"INFER_P2_SPECULATIVE": True}, {"INFER_P2_DEVICE_AGG": True}],
                         ids=["speculative", "device_agg"])
def test_abtest_engine_reports_the_pipeline_modes_without_warm_runs(model, img, b):
    """B in a pipeline mode against the whole-region path, at given
    thresholds and with no warm runs: the last round's outputs are equal,
    and B's speculation counters or device aggregation are reported."""
    engine = bench.make_engine("cpu", ENGINE, model)
    thresholds = bench.calibrate(engine, img)
    res = abtest_engine.main(b, 2, {"INFER_STREAM_PHASE1": False}, "cpu", model=model,
                             base=ENGINE, region=img, thresholds=thresholds, warm=False)
    assert res["same_outputs"] and res["a_graph"] == res["b_graph"] and res["a_graph"][1] > 0
    assert len(res["a_s"]) == len(res["b_s"]) == 2
    if "INFER_P2_SPECULATIVE" in b:
        assert {"spec_dispatched", "spec_hits", "spec_miss"} <= set(res["b_spec_last"])
        assert "b_agg_last" not in res
    else:
        assert res["b_agg_last"]["path"] == "device" and "b_spec_last" not in res


def test_abtest_engine_arms_pair_every_arm_with_one_a_run(model, img):
    """Several arms against one A: each round runs every arm, then A once,
    so every arm's paired differences take the same A times."""
    engine = bench.make_engine("cpu", ENGINE, model)
    thresholds = bench.calibrate(engine, img)
    over = {"stream": {}, "waves": {"INFER_P2_FETCH_WAVES": 2}}
    res = abtest_engine.arms(over, 2, {"INFER_STREAM_PHASE1": False}, "cpu", model=model,
                             base=ENGINE, region=img, thresholds=thresholds, warm=False)
    assert set(res) == set(over)
    a_s = res["stream"]["a_s"]
    assert len(a_s) == 2
    for name, r in res.items():
        assert r["overrides"] == over[name] and r["a_s"] == a_s and len(r["b_s"]) == 2
        assert r["paired_delta_a_minus_b"] == [a - b for a, b in zip(a_s, r["b_s"])]
        assert r["same_outputs"] and r["a_graph"] == r["b_graph"] and r["a_graph"][1] > 0
        _times_ok(r)


def test_abtest_engine_builds_b_from_its_own_config(model, img):
    """B's switches reach its model (FLASH_ATTENTION is a model switch),
    on A's weights: here the same function, so the same graph."""
    res = abtest_engine.main({"FLASH_ATTENTION": False, "FUSED_ENCODER": False}, 1,
                             {"FUSED_ENCODER": False}, "cpu", model=model, base=ENGINE,
                             region=img)
    assert res["a_graph"][1] > 0
    assert abs(res["a_graph"][0] - res["b_graph"][0]) <= 2


def test_experiment_infer_batch_sizes_agree(model, img):
    rows, outs = {}, {}
    for b in (4, 8):
        rows[b], outs[b] = experiment_infer_batch.variant(model, ENGINE, img, b, True, 1, "cpu")
    (n4, e4, kp4, road4), (n8, e8, kp8, road8) = outs[4], outs[8]
    assert np.abs(kp4.astype(int) - kp8.astype(int)).max() <= 1
    assert np.abs(road4.astype(int) - road8.astype(int)).max() <= 1
    s4, s8 = _edge_set(n4, e4), _edge_set(n8, e8)
    assert len(s4) > 50 and len(s4 & s8) / len(s4 | s8) >= 0.95
    assert rows[4]["nodes"] == n4.shape[0]


def test_experiment_infer_batch_main(model, img):
    res = experiment_infer_batch.main((4, 8), "cpu", fused=(1, 0), runs=1, model=model,
                                      overrides=ENGINE, region=img)
    assert set(res) == {"device", "B4_fused", "B8_fused", "B4_eager", "B8_eager"}
    for key, row in res.items():
        if key != "device":
            assert row["min_s"] == min(row["all_runs_s"]) and row["nodes"] > 0
    _times_ok(res)


def test_encoder_flops_at_the_bench_geometry():
    """ViT-B at 512 px: 227.09 GFLOP a patch (the windowed blocks' qkv and
    proj over the 42 x 42 padded grid, their MLP over the 32 x 32 tokens)."""
    assert profile_encoder.encoder_flops(512, 768, 12, 14, (2, 5, 8, 11)) == 227090300928.0
    N, P = 1024, 1764
    want = 2 * P * 768 * 4 * 768 + 4 * 9 * 196 ** 2 * 768 + 4 * P * 14 * 768 + 4 * N * 768 * 3072
    assert profile_encoder.block_flops(P, 768, 14, 9, True, mlp_tokens=N) == want


def test_profile_encoder_main():
    res = profile_encoder.main("cpu", iters=2, rounds=2, **SMALL_ENCODER)
    for name in ("full_encoder", "windowed_block", "windowed_block_norelpos", "global_block",
                 "global_block_norelpos", "mlp_only"):
        assert res[name + "_tflops"] > 0 and res[name + "_gflop"] > 0
    assert res["windowed_block_gflop"] > res["windowed_block_norelpos_gflop"]
    _times_ok(res)


@pytest.mark.parametrize("window", [0, 5])
def test_block_without_rel_pos_matches_jax(window):
    """models/vit.py's Block with use_rel_pos=False (profile_encoder's
    _norelpos blocks) against the JAX Block: 12 x 12 tokens, so a global
    block takes K5's plain version, a windowed one the einsum path."""
    x = np.random.default_rng(0).normal(size=(2, 12, 12, 32)).astype(np.float32)
    jblk = JBlock(dim=32, num_heads=2, mlp_ratio=4.0, window_size=window, input_size=(12, 12),
                  use_rel_pos=False)
    params = jblk.init(jax.random.PRNGKey(1), x)["params"]
    assert "rel_pos_h" not in params["attn"]
    blk = load_flax_params(Block(32, 2, 4.0, window, (12, 12), use_rel_pos=False),
                           jax.tree.map(np.asarray, params), scope="image_encoder")
    want = np.asarray(jblk.apply({"params": params}, x))
    with torch.no_grad():
        got = blk(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_experiment_fused_encoder_modes_are_bit_equal_and_restored():
    before = {k: getattr(fe, k) for k in experiment_fused_encoder.DEFAULTS}
    res = experiment_fused_encoder.main(None, "cpu", iters=1, rounds=2, **SMALL_ENCODER)
    assert {k: getattr(fe, k) for k in before} == before
    for lb in experiment_fused_encoder.VARIANTS:
        assert res[lb + "_bit_equal_to_v3"], lb
        assert res[lb + "_l1_diff_to_eager"] <= 2e-2 * res["eager_l1"]
        assert len(res[lb + "_ms_rounds"]) == 2 and res[lb + "_paired_speedup_median"] > 0
    _times_ok(res)
    with pytest.raises(ValueError, match="v3"):
        experiment_fused_encoder.main({"v3g4": {"WIN_GROUP_BATCH": 4}}, "cpu", **SMALL_ENCODER)


def test_encoder_switches_restore_the_module_after_an_error():
    before = {k: getattr(fe, k) for k in experiment_fused_encoder.DEFAULTS}
    with pytest.raises(RuntimeError):
        with experiment_fused_encoder.encoder_switches({"PAD_FREE": True, "WIN_GROUP_BATCH": 8}):
            assert fe.PAD_FREE and fe.WIN_GROUP_BATCH == 8 and not fe.WIN_ROLLED_ROWS
            raise RuntimeError("inside")
    assert {k: getattr(fe, k) for k in before} == before
