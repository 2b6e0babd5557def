"""The port's mesh helpers (parallel/mesh.py) and the engine's patch-row
banding (inference/engine.py::band_assignment) against the JAX engine's
_band_assignment, on the CPU."""

import types

import numpy as np
import pytest
import torch

from sam_road_tpu.data.partitions import get_patch_info_one_img as jget_patch_info_one_img
from sam_road_tpu.inference.engine import TiledInferenceEngine as JTiledInferenceEngine
from sam_road_tpu_torch.data.partitions import get_patch_info_one_img
from sam_road_tpu_torch.inference.engine import band_assignment
from sam_road_tpu_torch.parallel import (
    batch_sharding,
    make_mesh,
    replicate,
    replicated_sharding,
    shard_batch,
)


def test_make_mesh_takes_the_devices_it_is_given():
    mesh = make_mesh(devices=["cpu"] * 4)
    assert mesh.size == 4 and mesh.axis_names == ("dp",)
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert make_mesh(2, ["cpu"] * 4).size == 2
    with pytest.raises(ValueError, match="only 4"):
        make_mesh(8, ["cpu"] * 4)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_make_mesh_defaults_to_cuda_and_raises_without_it():
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()


def test_batch_and_replicated_sharding():
    mesh = make_mesh(devices=["cpu"] * 4)
    x = torch.arange(24.0).reshape(8, 3)
    parts = batch_sharding(mesh)(x)
    assert len(parts) == 4 and all(p.shape == (2, 3) for p in parts)
    torch.testing.assert_close(torch.cat(parts), x, rtol=0, atol=0)
    with pytest.raises(ValueError, match="divide"):
        batch_sharding(mesh)(x[:6])
    copies = replicated_sharding(mesh)(x)
    assert len(copies) == 4 and all(c is copies[0] for c in copies)  # one CPU copy, shared
    torch.testing.assert_close(copies[0], x, rtol=0, atol=0)
    module = torch.nn.Linear(3, 2)
    assert all(r is module for r in replicate(module, mesh))


def test_shard_batch_cuts_each_ranks_rows():
    rng = np.random.default_rng(0)
    batch = {"rgb": rng.integers(0, 255, (8, 4, 4, 3)).astype(np.uint8),
             "valid": rng.random((8, 5, 2)) < 0.5, "sample_weight": np.ones(8, np.float32)}
    parts = [shard_batch(batch, r, 4) for r in range(4)]
    for key, val in batch.items():
        assert all(p[key].shape[0] == 2 for p in parts)
        np.testing.assert_array_equal(np.concatenate([p[key] for p in parts]), val)
    with pytest.raises(ValueError, match="divide"):
        shard_batch(batch, 0, 3)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("region,patch,per_edge,margin", [
    (192, 64, 3, 8), (256, 64, 4, 8), (320, 96, 5, 16), (384, 64, 7, 8), (512, 128, 6, 32)])
def test_band_assignment_equals_the_jax_engines(n, region, patch, per_edge, margin):
    """Per-shard patch lists, band offsets and band height, against the JAX
    engine's _band_assignment over the same patch grid (the port's and
    JAX's get_patch_info_one_img agree)."""
    infos = get_patch_info_one_img(0, region, margin, patch, per_edge)
    jinfos = jget_patch_info_one_img(0, region, margin, patch, per_edge)
    assert [i[1:] for i in infos] == [tuple(j[1:]) for j in jinfos]
    want = JTiledInferenceEngine._band_assignment(
        types.SimpleNamespace(n_shards=n, patch_size=patch), jinfos, region)
    got = band_assignment(infos, region, n, patch)
    assert got == want
    per_dev, offs, band_h = got
    assert sorted(i for g in per_dev for i in g) == list(range(len(infos)))
    used = [off for g, off in zip(per_dev, offs) if g]  # a shard with no row keeps 0
    assert used == sorted(used) and patch <= band_h <= region
