"""The port's engine pipeline modes (inference/engine.py) on the CPU, at the
JAX engine tests' tiny geometry (tests/test_inference_engine.py: vit_t, 64
px patches, batch 4, 4 patches an edge, a 192 px region, fp32), on JAX
`init_params` weights carried across.

Within the port, every mode is held bit for bit to the whole-region path
(INFER_STREAM_PHASE1 off, no other mode): masks, vertices and edges equal,
as tests/test_inference_engine.py:135-420 holds the JAX engine's modes to
its own. Each mode also meets the JAX engine in the same mode within
tests/test_torch_engine.py::test_engine_matches_jax_engine's bounds (masks
within 1 uint8 level, vertex counts within 2, edge-set Jaccard >= 0.95),
with the same `last_timings` keys; `_stream_plan` equals JAX's exactly.
"""

import importlib.util
import itertools
import os
import types

import jax
import numpy as np
import pytest
import torch

from sam_road_tpu import config as jconfig
from sam_road_tpu.data.partitions import get_patch_info_one_img as jpatch_info
from sam_road_tpu.inference.engine import TiledInferenceEngine as JEngine
from sam_road_tpu.models.sam_road import init_params
from sam_road_tpu_torch import config
from sam_road_tpu_torch.data.partitions import get_patch_info_one_img
from sam_road_tpu_torch.inference import engine as engine_mod
from sam_road_tpu_torch.inference.engine import TIMING_KEYS, TiledInferenceEngine, _unpack_bits
from sam_road_tpu_torch.models.convert import load_flax_params
from sam_road_tpu_torch.models.sam_road import SAMRoad
from sam_road_tpu_torch.parallel import make_mesh
from test_torch_engine import _edge_set, _load_jax_native

TINY = dict(
    SAM_VERSION="vit_t", PATCH_SIZE=64, INFER_BATCH_SIZE=4, INFER_PATCHES_PER_EDGE=4,
    SAMPLE_MARGIN=8, COMPUTE_DTYPE="float32", ITSC_THRESHOLD=0.9, ROAD_THRESHOLD=0.45,
    TOPO_THRESHOLD=0.4, ITSC_NMS_RADIUS=4, ROAD_NMS_RADIUS=8, NEIGHBOR_RADIUS=24,
    MAX_NEIGHBOR_QUERIES=4,
)
WHOLE = dict(INFER_STREAM_PHASE1=False)
# JAX's speculative test geometry: 64 patches in batches of 8, sparse vertices
SPEC = dict(TINY, INFER_BATCH_SIZE=8, INFER_PATCHES_PER_EDGE=8, ROAD_THRESHOLD=0.52)


@pytest.fixture(autouse=True, scope="module")
def jax_native():
    _load_jax_native()


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, jax.jit(
        lambda: init_params(jconfig.load_config(overrides=TINY)))())


@pytest.fixture(scope="module")
def model(params):
    return load_flax_params(SAMRoad.from_config(config.load_config(overrides=TINY)), params)


@pytest.fixture(scope="module")
def img():
    return np.random.default_rng(12).integers(0, 255, (192, 192, 3), dtype=np.uint8)


def _chip_smoke():
    """chip_smoke.py, whose card checks this file holds on the CPU."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _engine(model, over=None, base=TINY, mesh=None):
    return TiledInferenceEngine(config.load_config(overrides={**base, **(over or {})}), model,
                                "cpu", point_bucket=16, mesh=mesh)


@pytest.fixture(scope="module")
def whole(model, img):
    """The whole-region path's (nodes, edges, keypoint mask, road mask)."""
    engine = _engine(model, WHOLE)
    out = engine.infer_one_img(img)
    assert out[0].shape[0] > 10 and out[1].shape[0] > 50, "fixture must exercise real edges"
    return out


def _assert_same(got, want):
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_bands,batch", [(2, 4), (3, 4), (3, 8)])
def test_banded_upload_bit_identical(model, img, whole, n_bands, batch):
    """Row slabs, all sent first; at batch 8 the one-row bands are half a
    batch, padded with patches that fuse nowhere."""
    engine = _engine(model, {**WHOLE, "INFER_UPLOAD_BANDS": n_bands, "INFER_BATCH_SIZE": batch})
    p1 = engine._run_phase1(img)
    assert p1["plan"] is None and len(p1["masks"]) == 1
    assert any(None in info for _, info in p1["batches"]) == (batch == 8)
    want = whole if batch == 4 else _engine(
        model, {**WHOLE, "INFER_BATCH_SIZE": batch}).infer_one_img(img)
    _assert_same(engine._finish(p1), want)


@pytest.mark.parametrize("taper", [False, True], ids=["even", "taper"])
@pytest.mark.parametrize("n_bands", [2, 3, 4])
def test_streamed_phase1_bit_identical(model, img, whole, n_bands, taper):
    """Disjoint column slabs, the accumulator's overlap carried from band
    to band, a mask chunk a band: the masks are the whole path's bit for
    bit at any band count."""
    engine = _engine(model, dict(INFER_STREAM_BANDS=n_bands, INFER_STREAM_TAPER=taper))
    infos = get_patch_info_one_img(0, 192, 8, 64, 4)
    plan = engine._stream_plan(infos, 192, n_bands)
    assert plan is not None and len(plan) == n_bands
    assert plan[0]["i0"] == 0 and plan[-1]["i1"] == len(infos)
    assert all(b["i1"] == c["i0"] for b, c in zip(plan, plan[1:]))
    assert all(b["a"] < c["a"] for b, c in zip(plan, plan[1:]))
    assert plan[-1]["e"] == 192
    p1 = engine._run_phase1(img)
    assert p1["plan"] == plan
    # chunk i holds columns [a_i, a_{i+1})
    widths = [c.shape[1] for c in p1["masks"]]
    assert widths == [b["a"] - a["a"] for a, b in zip(plan, plan[1:])] + [192 - plan[-1]["a"]]
    _assert_same(engine._finish(p1), whole)


@pytest.mark.parametrize("serial", [False, True], ids=["concurrent", "serial"])
def test_streamed_upload_order_changes_nothing(model, img, whole, serial):
    _assert_same(_engine(model, dict(INFER_STREAM_SERIAL_UPLOAD=serial)).infer_one_img(img),
                 whole)


@pytest.mark.parametrize("taper", [False, True], ids=["even", "taper"])
@pytest.mark.parametrize("n_bands", [1, 2, 3, 4, 5])
def test_stream_plan_matches_jax(n_bands, taper):
    """The plan over a grid of (region, batch, patches an edge, patch size),
    the port's against JAX's, None where JAX's is None."""
    seen = 0
    for size, B, ppe, p in itertools.product((192, 256, 448, 2048), (2, 4, 8, 16, 32),
                                             (2, 3, 4, 8, 16), (64, 512)):
        if p + 8 > size:
            continue
        infos = get_patch_info_one_img(0, size, 8, p, ppe)
        assert infos == jpatch_info(0, size, 8, p, ppe)
        cfg = types.SimpleNamespace(INFER_STREAM_TAPER=taper)
        eng = types.SimpleNamespace(batch_size=B, patch_size=p, config=cfg)
        got = TiledInferenceEngine._stream_plan(eng, infos, size, n_bands)
        want = JEngine._stream_plan(eng, infos, size, n_bands)
        assert got == want, (size, B, ppe, p)
        seen += got is not None
    assert seen > 20


def test_stream_plan_of_the_bench_region():
    """2048 px, 16 patches an edge of 512 px, batch 32, 4 tapered bands:
    patch columns [0, 2), [2, 8), [8, 14) and [14, 16)."""
    infos = get_patch_info_one_img(0, 2048, 64, 512, 16)
    eng = types.SimpleNamespace(batch_size=32, patch_size=512,
                                config=types.SimpleNamespace(INFER_STREAM_TAPER=True))
    plan = TiledInferenceEngine._stream_plan(eng, infos, 2048, 4)
    assert [(b["i0"] // 16, b["i1"] // 16) for b in plan] == [(0, 2), (2, 8), (8, 14), (14, 16)]


@pytest.mark.parametrize("waves,batch", [(2, 4), (3, 2)])
def test_p2_fetch_waves_exact(model, img, whole, waves, batch):
    """A shape's batches fetched in `waves` dispatch-ordered waves (at
    least two batches a wave), each cut to its own point count."""
    over = dict(INFER_BATCH_SIZE=batch)
    engine = _engine(model, dict(over, INFER_P2_FETCH_WAVES=waves))
    p1 = engine._run_phase1(img)
    assert len(p1["batches"]) >= 2 * waves
    want = whole if batch == 4 else _engine(model, dict(WHOLE, **over)).infer_one_img(img)
    _assert_same(engine._finish(p1), want)


def test_p2_packed_args_exact(model, img, whole):
    engine = _engine(model, dict(INFER_P2_PACK_ARGS=True))
    _assert_same(engine.infer_one_img(img), whole)
    assert engine.last_agg is None


def test_p2_device_agg_exact(model, img, whole):
    engine = _engine(model, dict(INFER_P2_DEVICE_AGG=True))
    _assert_same(engine.infer_one_img(img), whole)
    agg = engine.last_agg
    assert agg["path"] == "device" and agg["vertices"] == whole[0].shape[0]
    assert agg["E"] >= whole[1].shape[0] and agg["E_pad"] >= agg["E"] + 1


def test_p2_device_agg_no_valid_pairs(model, img):
    """A tiny NEIGHBOR_RADIUS leaves every pair slot invalid: no dispatch,
    no edges, as the host path."""
    engine = _engine(model, dict(NEIGHBOR_RADIUS=1e-3, INFER_P2_DEVICE_AGG=True))
    nodes, edges, _, _ = engine.infer_one_img(img)
    assert nodes.shape[0] > 0 and edges.shape == (0, 2)
    assert engine.last_agg["E"] == 0
    host = _engine(model, dict(NEIGHBOR_RADIUS=1e-3)).infer_one_img(img)
    _assert_same((nodes, edges), host[:2])


@pytest.mark.parametrize("limit", ["verts", "edges"])
def test_p2_device_agg_auto_fallback(model, img, whole, monkeypatch, capsys, limit):
    """Below the region's vertex or edge count, the uint16 limits send it
    to the host aggregation with JAX's line, and nothing changes."""
    monkeypatch.setattr(engine_mod, "_AGG_MAX_VERTS" if limit == "verts" else
                        "_AGG_MAX_EDGE_PAD", 2)
    engine = _engine(model, dict(INFER_P2_DEVICE_AGG=True))
    out = engine.infer_one_img(img)
    assert "falling back to host edge aggregation" in capsys.readouterr().out
    assert engine.last_agg["path"] == "host"
    _assert_same(out, whole)


def test_speculative_phase2_exact_hits_and_forced_miss(params):
    """JAX's speculative test, on the port: with hits (a 448 px region of
    sparse vertices) the outputs equal the plain engine's; an entry whose
    points were tampered with is refused and dispatched again."""
    model = load_flax_params(SAMRoad.from_config(config.load_config(overrides=SPEC)), params)
    img = np.random.default_rng(3).integers(0, 255, (448, 448, 3), dtype=np.uint8)
    base = _engine(model, base=SPEC).infer_one_img(img)
    assert base[0].shape[0] > 0, "fixture must extract vertices"
    spec = _engine(model, dict(INFER_P2_SPECULATIVE=True), base=SPEC)
    got = spec.infer_one_img(img)
    t = spec.last_timings
    assert t["spec_dispatched"] >= 1 and t["spec_hits"] >= 1 and t["spec_miss"] == 0, t
    _assert_same(got, base)

    p1 = spec._run_phase1(img)
    entries = p1["spec"]["entries"]
    assert entries, "speculation must engage"
    entries[next(iter(entries))][1][0, 0, 0] ^= 1  # tamper with bpoints
    _assert_same(spec._finish(p1), base)
    assert spec.last_timings["spec_miss"] >= 1


def test_speculation_hits_where_no_candidate_lies_past_the_frontier(params):
    """chip_smoke.py's region where speculation must hit: with every
    column from the last band's anchor black and the thresholds above the
    masks' maxima there, the provisional vertices are the final ones, so
    every speculative batch is taken and the outputs equal the plain
    engine's."""
    spec_region = _chip_smoke().spec_region
    model = load_flax_params(SAMRoad.from_config(config.load_config(overrides=SPEC)), params)
    img = np.random.default_rng(3).integers(0, 255, (448, 448, 3), dtype=np.uint8)
    whole, spec = _engine(model, WHOLE, base=SPEC), _engine(model, dict(INFER_P2_SPECULATIVE=True),
                                                            base=SPEC)

    def masks_of(region):
        whole.config.ITSC_THRESHOLD = whole.config.ROAD_THRESHOLD = 1.0
        return whole.infer_one_img(region)[2:]

    plan = spec._run_phase1(img)["plan"]
    region, thresholds = spec_region(img, masks_of, plan[-1]["a"])
    assert not region[:, plan[-1]["a"]:].any()
    for engine in (whole, spec):
        engine.config.update(thresholds)
    want = whole.infer_one_img(region)
    assert want[0].shape[0] > 0, "fixture must extract vertices"
    _assert_same(spec.infer_one_img(region), want)
    t = spec.last_timings
    assert t["spec_dispatched"] >= 1 and t["spec_hits"] == t["spec_dispatched"], t
    assert t["spec_miss"] == 0, t


def test_speculation_needs_the_plain_streamed_path(model, img, whole):
    """JAX's conditions: no speculation with packed arguments, device
    aggregation or the whole-region path."""
    for over in (dict(INFER_P2_PACK_ARGS=True), dict(INFER_P2_DEVICE_AGG=True), WHOLE):
        engine = _engine(model, dict(over, INFER_P2_SPECULATIVE=True))
        p1 = engine._run_phase1(img)
        assert p1["spec"] is None
        _assert_same(engine._finish(p1), whole)
        assert not any(k.startswith("spec") for k in engine.last_timings)


def test_compact_phase2_arguments_decode(model, img, whole):
    """The bits unpack as np.unpackbits does, and a batch's scores from the
    compact arguments equal TopoNet's on the decoded ones."""
    rng = np.random.default_rng(5)
    for k in (1, 4, 8, 9, 16):
        bits = rng.random((3, 5, k)) < 0.5
        packed = torch.from_numpy(np.packbits(bits, axis=-1))
        np.testing.assert_array_equal(_unpack_bits(packed, k).numpy(), bits)
    engine = _engine(model)
    p1 = engine._run_phase1(img)
    feats, info = p1["batches"][0]
    per_patch, bpoints, btgt, bvalid_packed, S, bvalid = engine._build_args(info, whole[0][:, ::-1])
    assert bpoints.dtype == np.uint16 and btgt.dtype == np.int16 and bvalid_packed.dtype == np.uint8
    q = engine._scores_q(feats, *engine._put(bpoints, btgt, bvalid_packed))
    src = np.broadcast_to(np.arange(S)[None, :, None], btgt.shape)
    pairs = torch.from_numpy(np.stack([src, btgt.astype(np.int64)], axis=-1))
    with torch.no_grad():
        s = model.infer_toponet(feats, torch.from_numpy(bpoints.astype(np.float32)), pairs,
                                torch.from_numpy(bvalid)).float()
    assert torch.equal(q, torch.round(s.clamp(-1, 1) * 32767).to(torch.int16))


def test_dp_takes_none_of_the_modes(model, img, whole):
    """A DP mesh keeps its row banding under every mode key, as in JAX."""
    over = dict(INFER_UPLOAD_BANDS=2, INFER_P2_SPECULATIVE=True, INFER_P2_DEVICE_AGG=True,
                INFER_P2_PACK_ARGS=True)
    dp = _engine(model, over, mesh=make_mesh(2, ["cpu"] * 2))
    p1 = dp._run_phase1(img)
    assert p1["plan"] is None and p1["spec"] is None and len(p1["masks"]) == 1
    assert all(isinstance(f, list) for f, _ in p1["batches"])
    got = dp._finish(p1)
    assert dp.last_agg is None
    _assert_same(got, whole)


MODES = {
    "whole": WHOLE,
    "streamed": {},
    "streamed_2_even": dict(INFER_STREAM_BANDS=2, INFER_STREAM_TAPER=False),
    "concurrent_upload": dict(INFER_STREAM_SERIAL_UPLOAD=False),
    "banded_upload": dict(WHOLE, INFER_UPLOAD_BANDS=2),
    "fetch_waves": dict(INFER_P2_FETCH_WAVES=2),
    "pack_args": dict(INFER_P2_PACK_ARGS=True),
    "device_agg": dict(INFER_P2_DEVICE_AGG=True),
    "speculative": dict(INFER_P2_SPECULATIVE=True),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_matches_jax_engine_in_the_same_mode(params, model, img, mode):
    over = {**TINY, **MODES[mode]}
    jeng = JEngine(jconfig.load_config(overrides=over), params, point_bucket=16)
    teng = _engine(model, MODES[mode])
    n0, e0, kp0, road0 = jeng.infer_one_img(img)
    n1, e1, kp1, road1 = teng.infer_one_img(img)
    assert np.abs(kp0.astype(int) - kp1.astype(int)).max() <= 1
    assert np.abs(road0.astype(int) - road1.astype(int)).max() <= 1
    assert abs(n0.shape[0] - n1.shape[0]) <= 2
    s0, s1 = _edge_set(n0, e0), _edge_set(n1, e1)
    assert len(s0) > 50
    assert len(s0 & s1) / len(s0 | s1) >= 0.95
    # every JAX key, and beyond them exactly the port's (p1_device on CUDA alone)
    assert set(jeng.last_timings) <= set(teng.last_timings)
    assert set(teng.last_timings) - set(jeng.last_timings) == set(TIMING_KEYS) - {"p1_device"}


def test_sp_streamed_phase1_matches_sp_whole_region(model):
    """SP over a CPU mesh of 4 (tests/test_multichip_inference.py:138):
    the streamed bands run the SP encoder, bit-equal to SP's whole-region
    path."""
    geometry = dict(TINY, INFER_BATCH_SIZE=8, SP_SHARDS=4)
    img = np.random.default_rng(0).integers(0, 255, (256, 256, 3), dtype=np.uint8)
    mesh = make_mesh(4, ["cpu"] * 4)
    whole_sp = _engine(model, WHOLE, base=geometry, mesh=mesh).infer_one_img(img)
    stream = _engine(model, base=geometry, mesh=mesh)
    p1 = stream._run_phase1(img)
    assert p1["plan"] is not None and len(p1["masks"]) == len(p1["plan"]) >= 2
    got = stream._finish(p1)
    assert got[0].shape[0] > 0
    np.testing.assert_array_equal(got[2], whole_sp[2])
    np.testing.assert_array_equal(got[3], whole_sp[3])
    np.testing.assert_array_equal(got[0], whole_sp[0])
    assert _edge_set(got[0], got[1]) == _edge_set(whole_sp[0], whole_sp[1])
