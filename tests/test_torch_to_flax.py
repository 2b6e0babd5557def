"""models/convert.py::to_flax_params, the inverse of from_flax_params: the
port's weights as the JAX package's flax tree. At vit_t (the default
switches, and LoRA with the SAM decoder), the tree has init_params's paths
and shapes (jax.eval_shape), from_flax_params of it gives the state dict
back exactly, and the tree loads into a fresh port model."""

import jax
import numpy as np
import pytest
import torch

from sam_road_tpu.config import load_config as jload_config
from sam_road_tpu.models.sam_road import init_params
from sam_road_tpu_torch.config import load_config
from sam_road_tpu_torch.models.convert import from_flax_params, load_flax_params, to_flax_params
from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random

TINY = dict(SAM_VERSION="vit_t", PATCH_SIZE=64)
CONFIGS = [None, "configs/lora_enc_r4_dec_512.yaml"]


def _shapes(tree) -> dict:
    return {jax.tree_util.keystr(p): tuple(np.shape(v))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("path", CONFIGS, ids=["default", "lora_sam_decoder"])
def test_to_flax_params_has_init_params_paths_and_shapes(path):
    want = jax.eval_shape(lambda: init_params(jload_config(path, overrides=TINY)))
    model = init_random(SAMRoad.from_config(load_config(path, overrides=TINY)), 0)
    tree = to_flax_params(model)
    assert _shapes(tree) == _shapes(want)
    assert all(v.dtype == np.float32 for v in jax.tree.leaves(tree))


@pytest.mark.parametrize("path", CONFIGS, ids=["default", "lora_sam_decoder"])
def test_to_flax_params_round_trips_through_from_flax_params(path):
    model = init_random(SAMRoad.from_config(load_config(path, overrides=TINY)), 1)
    state = model.state_dict()
    back = from_flax_params(to_flax_params(model))
    assert set(back) == set(state)
    for key, value in state.items():
        assert torch.equal(back[key], value.float()), key
    again = load_flax_params(SAMRoad.from_config(load_config(path, overrides=TINY)),
                             to_flax_params(model))
    for key, value in again.state_dict().items():
        assert torch.equal(value, state[key]), key
