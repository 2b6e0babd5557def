"""The encoder family that a configuration names: SAM ViT's leaves and
counts as they were before the family became a module of its own, a new
family reached through one module and nothing else, the eager
configuration, and K5's roofline in the region cells."""

from __future__ import annotations

import hashlib
import math
import os
import re
import sys
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import cells, counts, run
from benchmark.reference import model, region as ref_region

from bench_tiny import REPO, read

# (leaves, the encoder's, sha256(repr(param_specs))[:16], encoder_flops,
# encoder_params, encoder_call_bytes(., 32), decoder_flops, attention_flops
# window / global), as the reference counted them before the families
PINNED = {
    "vitb_512_cityscale": (229, 177, "85e6dc570988f8dd", 195337125888.0, 87278848, 416224256.0,
                           838860800.0, 660602880.0, 3321888768.0),
    "vith_256_cityscale": (509, 457, "f3cacc26e9327053", 332228722688.0, 632049408,
                           2544974848.0, 209715200.0, 275251200.0, 356515840.0),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_sam_vit_leaves_and_counts_are_pinned(name):
    arch = cells.arch_of(read(f"benchmark/configs/{name}.json"))
    specs = model.param_specs(arch)
    got = (len(specs), sum(n.startswith("image_encoder.") for n, _, _ in specs),
           hashlib.sha256(repr(specs).encode()).hexdigest()[:16], counts.encoder_flops(arch),
           counts.encoder_params(arch), counts.encoder_call_bytes(arch, 32),
           counts.decoder_flops(arch), counts.attention_flops(arch, "window"),
           counts.attention_flops(arch, "global"))
    assert got == PINNED[name]


def toy_family() -> types.ModuleType:
    """A family of a 16 px patch embedding and a 1 x 1 neck."""
    mod = types.ModuleType("benchmark.reference.encoders.toy")
    e = "image_encoder."

    def grid(arch):
        return arch["PATCH_SIZE"] // 16

    def param_specs(arch):
        C, out = arch["embed_dim"], arch["out_chans"]
        return [(e + "embed.weight", (C, 3, 16, 16), "lecun"), (e + "embed.bias", (C,), "zero"),
                (e + "neck.weight", (out, C, 1, 1), "lecun")]

    def forward(sd, rgb, arch, prec=model.FP32):
        x = prec(rgb.float().permute(0, 3, 1, 2) / 255.0)
        x = prec(F.conv2d(x, sd[e + "embed.weight"], sd[e + "embed.bias"], stride=16))
        return prec(F.conv2d(x, sd[e + "neck.weight"]))

    def flops(arch):
        return 2.0 * grid(arch) ** 2 * arch["embed_dim"] * (3 * 256 + arch["out_chans"])

    def params(arch):
        return sum(math.prod(s) for _, s, _ in param_specs(arch))

    mod.__dict__.update(grid=grid, param_specs=param_specs, forward=forward, flops=flops,
                        params=params)
    return mod


def test_a_family_is_one_module(monkeypatch):
    """A family that only sys.modules knows reaches the weights, the
    forward, the region reference and the counts, with no other edit."""
    monkeypatch.setitem(sys.modules, "benchmark.reference.encoders.toy", toy_family())
    arch = {"encoder": "toy", "embed_dim": 8, "out_chans": 16, "topo_hidden": 8,
            "topo_heads": 2, "topo_layers": 1, "PATCH_SIZE": 32}
    sd = model.make_weights(arch, 3, "cpu")
    names = [n for n, _, _ in model.param_specs(arch)]
    assert list(sd) == names and names[:3] == ["image_encoder.embed.weight",
                                               "image_encoder.embed.bias",
                                               "image_encoder.neck.weight"]
    assert names[3] == "map_decoder.0.weight"
    rgb = torch.rand(2, 32, 32, 3) * 255
    assert model.encoder(sd, rgb, arch).shape == (2, 16, 2, 2)
    points = torch.rand(2, 5, 2) * 32
    pairs = torch.randint(0, 5, (2, 3, 4, 2))
    valid = torch.ones(2, 3, 4, dtype=torch.bool)
    masks, edges = model.forward(sd, arch, rgb, points, pairs, valid)
    assert masks.shape == (2, 32, 32, 2) and edges.shape == (2, 3, 4)
    img = np.random.default_rng(0).integers(0, 255, (64, 64, 3), dtype=np.uint8)
    cfg = {"PATCH_SIZE": 32, "SAMPLE_MARGIN": 0, "INFER_PATCHES_PER_EDGE": 2}
    fused, feats, origins = ref_region.masks_and_features(sd, arch, img, cfg, "cpu")
    assert fused.shape == (64, 64, 2) and feats.shape == (4, 16, 2, 2) and len(origins) == 4
    assert counts.encoder_flops(arch) == 2.0 * 4 * 8 * (768 + 16)
    assert counts.encoder_params(arch) == 8 * 768 + 8 + 16 * 8
    # a 2 x 2 grid: 16 -> 128 -> 64 -> 32 -> 2 channels at 4, 16, 64, 256 pixels
    assert counts.decoder_flops(arch) == 2 * (4 * 16 * 4 * 128 + 16 * 128 * 4 * 64
                                              + 64 * 64 * 4 * 32 + 256 * 32 * 4 * 2)


def test_only_a_family_reads_the_encoder_shapes():
    """Outside benchmark/reference/encoders/ no harness source reads a
    family's sizes, and none names SAM ViT's module but as the default."""
    shapes = re.compile(r"\[\"(patch_size|window_size|global_attn_indexes)\"\]")
    for folder, _, files in os.walk(os.path.join(REPO, "benchmark")):
        rel = os.path.relpath(folder, REPO)
        if rel.startswith(os.path.join("benchmark", "reference", "encoders")) or "tests" in rel:
            continue
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(folder, name)) as f:
                    text = f.read()
                assert not shapes.search(text), (rel, name)
                assert "sam_vit" not in text, (rel, name)


def test_the_eager_configuration_differs_only_in_the_encoder_switch():
    fused = read("benchmark/configs/vitb_512_cityscale.json")
    eager = read("benchmark/configs/vitb_512_cityscale_eager.json")
    assert fused["config"]["FUSED_ENCODER"] is True and eager["config"]["FUSED_ENCODER"] is False
    assert eager["name"] == "vitb_512_cityscale_eager"
    for d in (fused, eager):
        del d["config"]["FUSED_ENCODER"], d["name"]
    assert eager == fused


VITB = cells.arch_of(read("benchmark/configs/vitb_512_cityscale.json"))


def region_run(kernels, batches=(32, 32)):
    return {"kind": "region", "arch": VITB,
            "trace": {"kernels": kernels, "encoder_batches": list(batches)}}


def test_attention_roofline_region_reads_k5_alone():
    read_share = run.reader("attention_roofline.region")
    assert read_share({"kind": "train", "trace": {"kernels": {}}}) is None
    assert read_share(region_run({})) is None
    assert read_share(region_run({"relpos_attention_kernel": 0.0})) is None
    # K3 under the fused encoder shares K5's name; K2 gives it away
    assert read_share(region_run({"relpos_attention_kernel": 0.1,
                                  "window_attention_kernel": 0.2})) is None
    # ViT-B 512 px: 8 windowed blocks bound by bytes, 4 global by operations
    window = 2 * 768 * (2 * 1024 + 2 * 9 * 196) / 3.35e12
    glob = (4 * 1024 * 1024 * 768 + 4 * 1024 * 32 * 768) / 989e12
    bound = 64 * (8 * window + 4 * glob)
    got = read_share(region_run({"relpos_attention_kernel": 4 * bound,
                                 "window_attention_kernel": 0.0}))
    assert got == pytest.approx(25.0, rel=1e-12)


@pytest.mark.parametrize("cell", ["region.vitb_512", "region.vitb_512.eager"])
def test_traced_region_counts_every_encoder_call(tiny, cell):
    """The traced lap's encoder span wraps the engine's fused encoder, or
    the model's own where the engine runs the eager one: each of the lap's
    batches is recorded once (2 regions of 16 patches in batches of 8)."""
    spec, root = tiny
    work = next(w for w in spec["workloads"] if w["name"] == cell)
    config = run.read_json(next(c for c in spec["configs"] if c["name"] == work["config"])["file"],
                           root)
    mix = run.read_json(f"benchmark/traffic/{work['traffic']}.json", root)
    got = cells.region(config, mix, 2 ** 31 + 31, 0.2, True, torch.device("cpu"), 0.0)
    assert got["trace"]["encoder_batches"] == [8, 8, 8, 8]


def test_eager_region_cell_agrees(tiny):
    spec, root = tiny
    result, _, numbers = run.execute(spec, "region.vitb_512.eager", 2 ** 31 + 37, 0.5, False,
                                     torch.device("cpu"), root=root)
    assert numbers["vertex_mismatch"] == 0 and numbers["edge_mismatch"] == 0
    assert numbers["mask_gap"] <= 1 and numbers["score_patch_gap"] < 1e-4
    assert result["correct"] and result["attempted"] >= 1
