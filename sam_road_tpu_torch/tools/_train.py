"""What the training measurement tools share: the configuration they run,
the JAX tools' fake batch (tools/experiment_fused_train.py::_fake_batch),
one model with its Adam and train step, the parameters whose movement they
report, and freeing a configuration before the next.

Every step goes through training/harness.py::make_train_step, which ends in
a host read of the loss (a synchronise), so the tools time steps by the host
clock with a torch.cuda.synchronize() at each end of the span."""

from __future__ import annotations

import gc

import numpy as np

# reported as the max abs change over a tool's steps: the first encoder
# block's qkv, the map decoder's first layer, TopoNet's output layer
WATCH = ("image_encoder.blocks.0.attn.qkv.weight", "map_decoder.0.weight",
         "topo_net.output_proj.weight")
SEED = 0  # the JAX tools' PRNGKey(0) and default_rng(0): weights, batch, dropout
N_PTS = 256  # graph points in the fake batch
STEPS_PER_EPOCH = 100  # the JAX tools' build_optimizer(..., steps_per_epoch=100)


def train_config(base, defaults: dict, batch, overrides):
    """load_config(base) with `defaults` (the JAX tool's geometry) where no
    `base` config is given, then BATCH_SIZE `batch` (None: the config's),
    then `overrides`."""
    from sam_road_tpu_torch.config import load_config

    over = dict(defaults) if base is None else {}
    if batch is not None:
        over["BATCH_SIZE"] = int(batch)
    over.update(overrides or {})
    return load_config(base, overrides=over)


def fake_batch(config, batch: int) -> dict:
    """A batch in collate_batch's format at the config's PATCH_SIZE,
    TOPO_SAMPLE_NUM and MAX_NEIGHBOR_QUERIES from np.random.default_rng(SEED),
    drawn as the JAX tool draws it: uint8 rgb, masks 0 / 255, N_PTS graph
    points, pairs among them, connected and valid at random."""
    rng = np.random.default_rng(SEED)
    s, p = int(config.TOPO_SAMPLE_NUM), int(config.MAX_NEIGHBOR_QUERIES)
    ps = int(config.PATCH_SIZE)
    return {
        "rgb": rng.integers(0, 255, (batch, ps, ps, 3)).astype(np.uint8),
        "keypoint_mask": (rng.random((batch, ps, ps)) > 0.95).astype(np.uint8) * 255,
        "road_mask": (rng.random((batch, ps, ps)) > 0.8).astype(np.uint8) * 255,
        "graph_points": rng.uniform(0, ps, (batch, N_PTS, 2)).astype(np.float32),
        "pairs": rng.integers(0, N_PTS, (batch, s, p, 2)).astype(np.int32),
        "connected": rng.random((batch, s, p)) > 0.5,
        "valid": rng.random((batch, s, p)) > 0.2,
    }


def build_model(config, template=None):
    """SAMRoad.from_config(config) with `template`'s weights (its state dict
    copied: each caller trains its own copy), or random ones from SEED."""
    from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random

    model = SAMRoad.from_config(config)
    if template is None:
        return init_random(model, SEED)
    model.load_state_dict(template.state_dict())
    return model


def build_step(config, model, device, deterministic: bool = False):
    """(optimizer, train_step) for `model` moved to `device`: the harness's
    Adam groups and step (dropout off where `deterministic`)."""
    from sam_road_tpu_torch.training.harness import build_optimizer, make_train_step

    model.to(device)
    optimizer = build_optimizer(config, model)
    return optimizer, make_train_step(config, model, optimizer, STEPS_PER_EPOCH,
                                      deterministic=deterministic)


def snapshot(model) -> dict:
    """Copies of the WATCH parameters that `model` has."""
    named = dict(model.named_parameters())
    return {n: named[n].detach().clone() for n in WATCH if n in named}


def moved(model, before: dict) -> dict:
    """Max abs change of each snapshot parameter since `before`."""
    named = dict(model.named_parameters())
    return {n: (named[n].detach() - p).abs().max().item() for n, p in before.items()}


def free(device) -> None:
    """Collect what the last configuration left and return the allocator's
    cached blocks, so that the next configuration's peak stands alone."""
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
