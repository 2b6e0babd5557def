"""The port's engine over a mesh (inference/engine.py: DP patch banding and
SP token sharding) on the CPU, at the geometry of
tests/test_multichip_inference.py (vit_t, 64 px patches, a 256 px region,
batch 8, fp32). The port's meshes repeat the one CPU device; the JAX
engine's run on tests/conftest.py's 8 CPU devices. Bounds:
  DP vs the port's single device   masks bit-equal, vertices and edges equal
                                   (int32 mask sums are exact in any order)
  DP vs the JAX DP engine          masks within 1 uint8 level, vertex counts
                                   within 2 (tests/test_torch_engine.py's
                                   port-to-JAX bounds)
  SP vs the port's single device   masks within 1 level, vertex sets differ
                                   by at most max(2, n / 50)
                                   (tests/test_multichip_inference.py's)
"""

import jax
import numpy as np
import pytest

from sam_road_tpu.config import load_config as jload_config
from sam_road_tpu.inference.engine import TiledInferenceEngine as JEngine
from sam_road_tpu.models.sam_road import init_params
from sam_road_tpu.parallel.mesh import make_mesh as jmake_mesh
from sam_road_tpu_torch.config import load_config
from sam_road_tpu_torch.inference.engine import TiledInferenceEngine
from sam_road_tpu_torch.models.convert import load_flax_params
from sam_road_tpu_torch.models.sam_road import SAMRoad
from sam_road_tpu_torch.parallel import make_mesh
from test_torch_engine import _load_jax_native

GEOMETRY = dict(SAM_VERSION="vit_t", PATCH_SIZE=64, INFER_BATCH_SIZE=8, INFER_PATCHES_PER_EDGE=4,
                SAMPLE_MARGIN=8, COMPUTE_DTYPE="float32", ITSC_THRESHOLD=0.9,
                ROAD_THRESHOLD=0.45, TOPO_THRESHOLD=0.4, ITSC_NMS_RADIUS=4, ROAD_NMS_RADIUS=8,
                NEIGHBOR_RADIUS=24, MAX_NEIGHBOR_QUERIES=4)


@pytest.fixture(scope="module")
def setup():
    _load_jax_native()
    params = jax.tree.map(np.asarray, jax.jit(
        lambda: init_params(jload_config(overrides=GEOMETRY)))())
    model = load_flax_params(SAMRoad.from_config(load_config(overrides=GEOMETRY)), params)
    img = np.random.default_rng(0).integers(0, 255, (256, 256, 3), dtype=np.uint8)
    return params, model, img


def _engine(model, mesh=None, **over):
    return TiledInferenceEngine(load_config(overrides={**GEOMETRY, **over}), model, "cpu",
                                point_bucket=16, mesh=mesh)


def _cpu_mesh(n):
    return make_mesh(n, ["cpu"] * n)


@pytest.fixture(scope="module")
def single(setup):
    _, model, img = setup
    return {fused: _engine(model, FUSED_ENCODER=fused).infer_one_img(img)
            for fused in (False, True)}


def _edge_set(edges):
    return {tuple(sorted(map(int, e))) for e in edges}


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_dp_engine_matches_single_device_exactly(setup, single, n, fused):
    """n shards of 8 / n patches a round: 4 patch rows over n shards (at 8,
    four shards hold no row and run padding rounds)."""
    _, model, img = setup
    nodes1, edges1, kp1, road1 = single[fused]
    engine = _engine(model, _cpu_mesh(n), FUSED_ENCODER=fused)
    assert engine.n_shards == n
    nodes, edges, kp, road = engine.infer_one_img(img)
    np.testing.assert_array_equal(kp, kp1)
    np.testing.assert_array_equal(road, road1)
    np.testing.assert_array_equal(nodes, nodes1)
    assert _edge_set(edges) == _edge_set(edges1)
    assert nodes1.shape[0] > 0 and edges1.shape[0] > 0


def test_dp_engine_matches_the_jax_dp_engine(setup, single):
    params, model, img = setup
    jeng = JEngine(jload_config(overrides=GEOMETRY), params, point_bucket=16, mesh=jmake_mesh(8))
    nodes0, edges0, kp0, road0 = jeng.infer_one_img(img)
    nodes, edges, kp, road = _engine(model, _cpu_mesh(8)).infer_one_img(img)
    assert np.abs(kp0.astype(int) - kp.astype(int)).max() <= 1
    assert np.abs(road0.astype(int) - road.astype(int)).max() <= 1
    assert abs(nodes0.shape[0] - nodes.shape[0]) <= 2


def _vertex_gap(nodes_a, nodes_b):
    sa = {tuple(map(int, v)) for v in nodes_a}
    sb = {tuple(map(int, v)) for v in nodes_b}
    return len(sa ^ sb), len(sa)


@pytest.mark.parametrize("n", [1, 4], ids=["measurement_mode", "sp4"])
def test_sp_engine_matches_single_device(setup, single, n):
    """SP_SHARDS 4 (grid 4: one token row a shard) and SP_SHARDS 1 on a
    1-device mesh (the SP machinery with identity gathers)."""
    _, model, img = setup
    nodes1, _, kp1, road1 = single[False]
    engine = _engine(model, _cpu_mesh(n), SP_SHARDS=n)
    assert engine.sp_shards == n and engine.n_shards == 1
    nodes, _, kp, road = engine.infer_one_img(img)
    assert np.abs(kp1.astype(int) - kp.astype(int)).max() <= 1
    assert np.abs(road1.astype(int) - road.astype(int)).max() <= 1
    gap, count = _vertex_gap(nodes1, nodes)
    assert gap <= max(2, count // 50) and nodes.shape[0] > 0


def test_sp_engine_turns_fused_encoder_off(setup, capsys):
    _, model, _ = setup
    engine = _engine(model, _cpu_mesh(4), SP_SHARDS=4, FUSED_ENCODER=True)
    assert "FUSED_ENCODER disabled under SP_SHARDS" in capsys.readouterr().out
    assert engine.encoder is not None and engine.encoder.__name__ == "encoder"


def test_mesh_engines_reject_bad_geometry(setup):
    """Grid 4 cannot row-shard over 8; SP_SHARDS needs a mesh of its size;
    a batch of 6 cannot split over 8 shards."""
    _, model, _ = setup
    with pytest.raises(ValueError, match="must divide"):
        _engine(model, _cpu_mesh(8), SP_SHARDS=8)
    with pytest.raises(ValueError, match="mesh of that size"):
        _engine(model, _cpu_mesh(2), SP_SHARDS=4)
    with pytest.raises(ValueError, match="mesh of that size"):
        _engine(model, None, SP_SHARDS=1)
    with pytest.raises(ValueError, match="must divide by mesh size"):
        _engine(model, _cpu_mesh(8), INFER_BATCH_SIZE=6)
