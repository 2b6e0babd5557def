"""Weight bridge: the JAX package's flax parameter tree -> this package's
state dict (the inverse of sam_road_tpu/models/convert.py's
_convert_encoder_key / _convert_decoder_key / _convert_toponet_key).

The port's parameters carry the reference's torch names, so:
  Dense kernel (in, out)              -> Linear weight (out, in)
  Conv kernel HWIO                    -> Conv2d weight OIHW
  ConvTranspose2x2 kernel (2,2,in,out) -> ConvTranspose2d weight (in,out,2,2)
  LayerNorm scale                     -> weight
Any leaf the bridge cannot place, and any state-dict key it leaves unfilled,
raises.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# map_decoder flax module -> nn.Sequential slot of the reference decoder
_DECODER_SLOTS = {"up_0": "0", "ln_1": "1", "up_2": "3", "up_3": "5", "up_4": "7"}

_RENAMES = [  # flax module name -> torch module path, applied per segment
    (r"^blocks_(\d+)$", r"blocks.\1"),
    (r"^layers_(\d+)$", r"transformer_encoder.layers.\1"),
    (r"^neck_(\d+)$", r"neck.\1"),
    (r"^patch_embed_proj$", "patch_embed.proj"),
    (r"^mlp_lin(\d)$", r"mlp.lin\1"),
]


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _torch_name(path: tuple):
    """flax path -> (torch key, transform of the array)."""
    top, *mods, leaf = path
    if top not in ("image_encoder", "map_decoder", "topo_net"):
        raise KeyError(f"unknown top-level module in {'/'.join(path)}")
    if mods[-2:] == ["self_attn", "in_proj"]:  # nn.MultiheadAttention packing
        mods = mods[:-1]
        leaf = {"kernel": "in_proj_weight", "bias": "in_proj_bias"}[leaf]
    names = []
    for m in mods:
        if top == "map_decoder":
            m = _DECODER_SLOTS[m]
        else:
            for pat, rep in _RENAMES:
                m = re.sub(pat, rep, m)
        names.append(m)
    op = None
    if leaf in ("kernel", "in_proj_weight"):
        if top == "map_decoder":
            op = "convT"
        leaf = "weight" if leaf == "kernel" else leaf
        op = op or "kernel"
    elif leaf == "scale":
        leaf = "weight"
    return ".".join([top] + names + [leaf]), op


def _transform(arr: np.ndarray, op):
    if op == "convT":
        return arr.transpose(2, 3, 0, 1)
    if op == "kernel":
        if arr.ndim == 2:
            return arr.T
        if arr.ndim == 4:
            return arr.transpose(3, 2, 0, 1)
        raise ValueError(f"unexpected kernel rank {arr.ndim}")
    return arr


def from_flax_params(tree) -> dict:
    """Nested dict of numpy arrays (sam_road_tpu.models.sam_road.init_params
    after jax.tree.map(np.asarray, ...)) -> {torch key: float32 tensor}."""
    out = {}
    for path, arr in _flatten(tree):
        try:
            key, op = _torch_name(path)
        except (KeyError, ValueError) as e:
            raise KeyError(f"flax leaf {'/'.join(path)} has no counterpart") from e
        out[key] = torch.tensor(_transform(arr, op), dtype=torch.float32)
    return out


def load_flax_params(module: torch.nn.Module, tree, scope: str | None = None):
    """Load a flax tree into `module`. With `scope` (e.g. "image_encoder"),
    `tree` is that submodule's subtree and `module` its counterpart.
    Raises on any unconsumed leaf, unfilled key or shape mismatch."""
    state = from_flax_params({scope: tree} if scope else tree)
    if scope:
        state = {k[len(scope) + 1:]: v for k, v in state.items()}
    want = module.state_dict()
    extra = sorted(set(state) - set(want))
    missing = sorted(set(want) - set(state))
    if extra or missing:
        raise KeyError(f"bridge mismatch: unconsumed {extra}, unfilled {missing}")
    for k, v in state.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"{k}: flax shape {tuple(v.shape)} vs {tuple(want[k].shape)}")
    module.load_state_dict(state)
    return module
