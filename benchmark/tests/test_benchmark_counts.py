"""The work counts against hand counts at tiny sizes, and the rate
arithmetic of the end-to-end metrics."""

from __future__ import annotations

import math

import pytest

from benchmark import counts, run
from benchmark.reference import model

# a tiny ViT-B-like encoder: 32 px patches of 16 px tokens (a 2 x 2 grid),
# windows of 1 token, blocks 0 windowed and 1 global
TINY = {"embed_dim": 8, "depth": 2, "num_heads": 2, "global_attn_indexes": [1],
        "window_size": 1, "patch_size": 16, "mlp_ratio": 4.0, "out_chans": 4,
        "topo_hidden": 4, "topo_heads": 2, "topo_layers": 1, "PATCH_SIZE": 32}
VITB = {"embed_dim": 768, "depth": 12, "num_heads": 12, "global_attn_indexes": [2, 5, 8, 11],
        "window_size": 14, "patch_size": 16, "mlp_ratio": 4.0, "out_chans": 256,
        "topo_hidden": 128, "topo_heads": 4, "topo_layers": 3, "PATCH_SIZE": 512}
VITH = {**VITB, "embed_dim": 1280, "depth": 32, "num_heads": 16,
        "global_attn_indexes": [7, 15, 23, 31], "PATCH_SIZE": 256}


def test_encoder_flops_by_hand():
    # T = 4 tokens, C = 8, mlp 32, out 4
    embed = 2 * 4 * 8 * (3 * 16 * 16)
    block = 2 * 4 * 8 * (3 * 8 + 8 + 2 * 32)
    window = 4 * 4 * 1 * 8 + 4 * 4 * 1 * 8  # q.k and p.v against 1 key; rel-pos over 1 row
    glob = 4 * 4 * 4 * 8 + 4 * 4 * 2 * 8  # 4 keys; rel-pos over 2 rows
    neck = 2 * 4 * 8 * 4 + 2 * 4 * 4 * 4 * 9
    assert counts.encoder_flops(TINY) == embed + 2 * block + window + glob + neck


def test_attention_bytes_by_hand():
    # window: 4 real tokens, 4 windows of 1 key; global: 4 keys
    assert counts.attention_bytes(TINY, "window") == 2 * 8 * (2 * 4 + 2 * 4)
    assert counts.attention_bytes(TINY, "global", backward=True) == 2 * 8 * (3 * 4 + 4 * 4)
    # ViT-B's 32 x 32 grid pads to 3 x 3 windows of 14 x 14 keys
    assert counts.attention_bytes(VITB, "window") == 2 * 768 * (2 * 1024 + 2 * 9 * 196)


def test_decoder_and_toponet_by_hand():
    # 2 x 2 grid: 4 -> 128 -> 64 -> 32 -> 2 channels at 4, 16, 64, 256 pixels
    assert counts.decoder_flops(TINY) == 2 * (4 * 4 * 512 + 16 * 128 * 256 + 64 * 64 * 128
                                              + 256 * 32 * 8)
    # 3 points, 6 pairs in groups of 2, h 4, features 4, one layer
    layer = 2 * 6 * 4 * (3 * 4 + 3 * 4) + 4 * 6 * 2 * 4
    assert counts.toponet_flops(TINY, 3, 6, 2) == 2 * 3 * 4 * 4 + 2 * 6 * 10 * 4 + layer + 2 * 6 * 4


@pytest.mark.parametrize("arch", [TINY, VITB, VITH], ids=["tiny", "vit_b", "vit_h"])
def test_encoder_params_match_the_reference(arch):
    enc = [s for n, s, _ in model.param_specs(arch) if n.startswith("image_encoder.")]
    assert counts.encoder_params(arch) == sum(math.prod(s) for s in enc)


def test_vitb_patch_is_about_197_gflop():
    per_patch = counts.encoder_flops(VITB) + counts.decoder_flops(VITB)
    assert 190e9 < per_patch < 200e9


def test_roofline_takes_the_larger_bound():
    assert counts.roofline_s(989e12, 0) == pytest.approx(1.0)
    assert counts.roofline_s(0, 3.35e12) == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["region_s", "train_step_s"])
def test_rate_counts_the_whole_window(name):
    # ten units in 10 s, one of which stalled for 5 s: 1.5 s a unit, not
    # the median unit's 1 s
    steady = {"window_s": 10.0, "units": 10, "setup_s": 3.0, "peak_window": 2 ** 30}
    stalled = {**steady, "window_s": 15.0}
    assert run.end_to_end(name, steady) == pytest.approx(1.0)
    assert run.end_to_end(name, stalled) == pytest.approx(1.5)
    assert run.end_to_end("peak_mem_gib", steady) == pytest.approx(1.0)


def test_step_time_per_layer_counts_the_whole_window():
    # the training step's seconds, reported per layer: ten steps in 10 s
    # with one 5 s stall read 1.5 s a step
    read = run.reader("step_s.train")
    assert read({"kind": "train", "window_s": 10.0, "units": 10}) == pytest.approx(1.0)
    assert read({"kind": "train", "window_s": 15.0, "units": 10}) == pytest.approx(1.5)
    assert read({"kind": "train", "window_s": 1.0, "units": 0}) is None
    assert read({"kind": "region", "window_s": 10.0, "units": 10}) is None
