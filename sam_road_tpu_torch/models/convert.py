"""Checkpoint loading (counterpart of sam_road_tpu/models/convert.py), and
the weight bridge from the JAX package's flax parameter tree.

Checkpoints. A SAM .pth, a SAMRoad Lightning .ckpt or an MAE .pth is a torch
state dict whose keys are the reference's torch names, which are this
package's own, so conversion is the identity on names and layouts. What
stays is the reference's load semantics, as the JAX package keeps them:
the pos-embed and global rel-pos resize for PATCH_SIZE != 1024 with the
same F.interpolate calls and the substring quirk (resize_sam_pos_embed),
then a partial overlay by name and shape onto a freshly built SAMRoad that
reports the matched and mismatched parameter names (load_and_convert,
load_mae_encoder_params). A SAM checkpoint's mask_decoder.* keys and its
prompt encoder's pe_layer and no_mask_embed load into the SAM decoder
(USE_SAM_DECODER), a SAMRoad checkpoint's attn.qkv.linear_* keys into the
LoRA adapters (ENCODER_LORA); keys the model does not have (the prompt
encoder's point_embeddings, not_a_point_embed and mask_downscaling, as in
the JAX package; the decoder a config does not use) are skipped.
load_checkpoint reads this
package's own training checkpoints (ckpt_epoch_N.pt) strictly;
load_weights picks between the two by the file's content. A directory (a
JAX orbax checkpoint) raises: the port cannot read orbax.

The bridge (tests, chip_smoke.py) is the inverse of the JAX package's
_convert_encoder_key / _convert_decoder_key / _convert_toponet_key and
convert_sam_decoder_key.

The port's parameters carry the reference's torch names, so:
  Dense kernel (in, out)              -> Linear weight (out, in)
  Conv kernel HWIO                    -> Conv2d weight OIHW
  ConvTranspose2x2 kernel (2,2,in,out) -> ConvTranspose2d weight (in,out,2,2)
  LayerNorm scale                     -> weight
  no_mask_embed (256,)                -> nn.Embedding weight [1, 256]
Any leaf the bridge cannot place, and any state-dict key it leaves unfilled,
raises.
"""

from __future__ import annotations

import os
import re
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random
from sam_road_tpu_torch.models.vit import ENCODER_SPECS

# map_decoder flax module -> nn.Sequential slot of the reference decoder
_DECODER_SLOTS = {"up_0": "0", "ln_1": "1", "up_2": "3", "up_3": "5", "up_4": "7"}

_RENAMES = [  # flax module name -> torch module path, applied per segment
    (r"^blocks_(\d+)$", r"blocks.\1"),
    (r"^layers_(\d+)$", r"transformer_encoder.layers.\1"),
    (r"^neck_(\d+)$", r"neck.\1"),
    (r"^patch_embed_proj$", "patch_embed.proj"),
    (r"^mlp_lin(\d)$", r"mlp.lin\1"),
]
# the LoRA adapters: flax siblings of qkv, torch children of it
_LORA = ("linear_a_q", "linear_b_q", "linear_a_v", "linear_b_v")
# sam_decoder flax leaves / modules -> SAM's torch names
_SAM_PARAMS = {
    "pe_gaussian_matrix": "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix",
    "no_mask_embed": "prompt_encoder.no_mask_embed.weight",
    "iou_token": "mask_decoder.iou_token.weight",
    "mask_tokens": "mask_decoder.mask_tokens.weight",
}
_SAM_RENAMES = [
    (r"^layers_(\d+)$", r"layers.\1"),
    (r"^mlp_lin(\d)$", r"mlp.lin\1"),
    (r"^upscale_(\d)$", r"output_upscaling.\1"),
    (r"^hyper_mlps_(\d+)$", r"output_hypernetworks_mlps.\1"),
]


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _sam_decoder_name(mods: list, leaf: str):
    """sam_decoder/... flax path (below the top) -> (torch key, transform):
    the inverse of the JAX package's convert_sam_decoder_key."""
    if not mods:
        return _SAM_PARAMS[leaf], "row" if leaf == "no_mask_embed" else None
    names = []
    for m in mods:
        for pat, rep in _SAM_RENAMES:
            m = re.sub(pat, rep, m)
        names.append(m)
    op = None
    if leaf == "kernel":
        op = "convT" if mods[0].startswith("upscale_") else "kernel"
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    return ".".join(["mask_decoder"] + names + [leaf]), op


def _torch_name(path: tuple):
    """flax path -> (torch key, transform of the array)."""
    top, *mods, leaf = path
    if top == "sam_decoder":
        return _sam_decoder_name(mods, leaf)
    if top not in ("image_encoder", "map_decoder", "topo_net"):
        raise KeyError(f"unknown top-level module in {'/'.join(path)}")
    if mods[-2:] == ["self_attn", "in_proj"]:  # nn.MultiheadAttention packing
        mods = mods[:-1]
        leaf = {"kernel": "in_proj_weight", "bias": "in_proj_bias"}[leaf]
    if top == "image_encoder" and mods[-1:] and mods[-1] in _LORA:
        mods = mods[:-1] + ["qkv", mods[-1]]
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
    if op == "row":
        return arr[None]
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
    if scope:  # the SAM decoder's keys carry no prefix of its own
        state = {k.removeprefix(scope + "."): v for k, v in state.items()}
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


# ---------------------------------------------------------------- checkpoints


def _torch_load(path: str):
    if os.path.isdir(path):
        raise IsADirectoryError(
            f"{path} is a directory (a JAX orbax checkpoint?): the PyTorch port reads only "
            "torch files (SAM .pth, SAMRoad .ckpt, its own ckpt_epoch_N.pt)")
    with open(path, "rb") as f:
        return torch.load(f, map_location="cpu", weights_only=False)


def _unwrap(obj) -> dict:
    if isinstance(obj, Mapping) and "state_dict" in obj:  # Lightning's nesting
        obj = obj["state_dict"]
    return dict(obj)


def load_torch_state_dict(path: str) -> dict:
    """A .pth / .ckpt file as a state dict; unwraps Lightning's
    'state_dict' nesting."""
    return _unwrap(_torch_load(path))


def resize_sam_pos_embed(state_dict: dict, image_size: int, vit_patch_size: int,
                         global_attn_indexes) -> dict:
    """Resize the absolute pos embed and the global blocks' rel-pos tables
    to image_size (the reference's resize_sam_pos_embed, model.py:392-411,
    as the JAX package keeps it: bilinear F.interpolate, and the block
    index matched as a substring of the key, so "2" also hits block 12)."""
    new_state_dict = dict(state_dict)
    pos_embed = new_state_dict["image_encoder.pos_embed"]
    token_size = int(image_size // vit_patch_size)
    if pos_embed.shape[1] != token_size:
        pos_embed = F.interpolate(pos_embed.permute(0, 3, 1, 2), (token_size, token_size),
                                  mode="bilinear", align_corners=False)
        new_state_dict["image_encoder.pos_embed"] = pos_embed.permute(0, 2, 3, 1)
        rel_pos_keys = [k for k in state_dict if "rel_pos" in k]
        global_rel_pos_keys = [k for k in rel_pos_keys
                               if any(str(i) in k for i in global_attn_indexes)]
        for k in global_rel_pos_keys:
            rel_pos = new_state_dict[k]
            w = rel_pos.shape[1]
            rel_pos = F.interpolate(rel_pos[None, None], (token_size * 2 - 1, w),
                                    mode="bilinear", align_corners=False)
            new_state_dict[k] = rel_pos[0, 0]
    return new_state_dict


def overlay_state_dict(model: torch.nn.Module, loaded: Mapping):
    """Copy each of `model`'s state-dict entries whose name is in `loaded`
    with the same shape (the reference's partial load, model.py:375-390).
    Returns (matched, mismatched, skipped): model names loaded, model names
    left as they were, loaded names the model does not have."""
    state = model.state_dict()
    matched, mismatched = [], []
    with torch.no_grad():
        for name, param in state.items():
            value = loaded.get(name)
            if value is not None and tuple(np.shape(value)) == tuple(param.shape):
                param.copy_(torch.as_tensor(value))
                matched.append(name)
            else:
                mismatched.append(name)
    skipped = [k for k in loaded if k not in state]
    return matched, mismatched, skipped


def _fresh_model(config, seed: int):
    return init_random(SAMRoad.from_config(config), seed)


def _convert_and_overlay(state_dict: Mapping, config, model, seed: int):
    """The pos-embed resize where PATCH_SIZE != 1024 (as the JAX package's
    convert_state_dict), then the overlay onto `model` (default: fresh)."""
    size = int(config.PATCH_SIZE)
    if "image_encoder.pos_embed" in state_dict and size != 1024:
        state_dict = resize_sam_pos_embed(
            state_dict, size, 16, ENCODER_SPECS[str(config.SAM_VERSION)]["global_attn_indexes"])
    model = _fresh_model(config, seed) if model is None else model
    matched, mismatched, _ = overlay_state_dict(model, state_dict)
    return model, matched, mismatched


def load_and_convert(path: str, config, model=None, seed: int = 0):
    """A SAM .pth or SAMRoad .ckpt overlaid onto `model` (default: a fresh
    SAMRoad.from_config(config) with init_random(seed)): resize, then the
    name-and-shape partial overlay. Returns (model, matched, mismatched)
    with this package's parameter names."""
    return _convert_and_overlay(load_torch_state_dict(path), config, model, seed)


def load_mae_encoder_params(path: str, config, model=None, seed: int = 0):
    """NO_SAM ablation init: an IN1k-MAE ViT-B checkpoint ('model' nesting)
    overlaid onto the encoder of `model` (default as load_and_convert), as
    sam_road_tpu/models/convert.py::convert_mae_state_dict intends it: the
    trunk's patch embed, norms, qkv, proj and MLP (fc1 / fc2 as lin1 / lin2)
    transfer; pos_embed (MAE's carries a cls token) and the missing rel-pos
    tables stay as initialised. Returns (model, matched, mismatched)."""
    obj = _torch_load(path)
    if isinstance(obj, Mapping) and "model" in obj:
        obj = obj["model"]
    state = {}
    for key, value in dict(obj).items():
        sam_key = key.replace(".mlp.fc1.", ".mlp.lin1.").replace(".mlp.fc2.", ".mlp.lin2.")
        if sam_key != "pos_embed":
            state[f"image_encoder.{sam_key}"] = value
    model = _fresh_model(config, seed) if model is None else model
    matched, mismatched, _ = overlay_state_dict(model, state)
    return model, matched, mismatched


def _is_port_checkpoint(obj) -> bool:
    return isinstance(obj, Mapping) and "model" in obj and "step" in obj


def load_checkpoint(path: str, model) -> int:
    """This package's training checkpoint (training/harness.py::
    Trainer.save_checkpoint: 'model' and 'step') loaded strictly into
    `model`; returns the step."""
    obj = _torch_load(path)
    if not _is_port_checkpoint(obj):
        raise ValueError(f"{path} is not a checkpoint of this package's Trainer "
                         "(a dict with 'model' and 'step')")
    model.load_state_dict(obj["model"])
    return int(obj["step"])


def load_weights(path: str, config, seed: int = 0):
    """The inference and calibration CLIs' loader, picked by content: this
    package's ckpt_epoch_N.pt loads strictly (as load_checkpoint); a SAM
    .pth or SAMRoad .ckpt goes through load_and_convert's resize and
    overlay. Returns (model, mismatched names)."""
    obj = _torch_load(path)
    model = _fresh_model(config, seed)
    if _is_port_checkpoint(obj):
        model.load_state_dict(obj["model"])
        return model, []
    model, _, mismatched = _convert_and_overlay(_unwrap(obj), config, model, seed)
    return model, mismatched
