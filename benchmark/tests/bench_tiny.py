"""A tiny copy of the benchmark's cells for CPU tests: vit_t at 64 px
patches, 192 px regions, float32, the program's plain PyTorch versions in
place of its CUDA kernels; the region cell with the fused encoder and
with the eager one. make_tiny writes its configuration and traffic
files under a directory and returns (spec, root) for
benchmark.run.execute."""

from __future__ import annotations

import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VIT_T = {"embed_dim": 64, "depth": 2, "num_heads": 2, "global_attn_indexes": [1],
         "window_size": 14, "patch_size": 16, "mlp_ratio": 4.0, "out_chans": 256,
         "topo_hidden": 128, "topo_heads": 4, "topo_layers": 3}
TINY_CONFIG = dict(SAM_VERSION="vit_t", PATCH_SIZE=64, INFER_BATCH_SIZE=8, INFER_PATCHES_PER_EDGE=4,
                   SAMPLE_MARGIN=8, COMPUTE_DTYPE="float32", ITSC_NMS_RADIUS=4, ROAD_NMS_RADIUS=8,
                   NEIGHBOR_RADIUS=24, MAX_NEIGHBOR_QUERIES=4, BATCH_SIZE=2, TOPO_SAMPLE_NUM=8)
REGION_MIX = {"kind": "region", "regions": 2, "size": 192, "itsc_quantile": 0.99,
              "road_quantile": 0.92, "weights_seed": 0}
TRAIN_MIX = {"kind": "train", "batches": 3, "points_per_patch": [20, 40], "point_bucket": 16,
             "valid_share": 0.5, "connected_share": [0.1, 0.6], "keypoint_share": [0.005, 0.08],
             "road_share": [0.02, 0.4], "checked_steps": 3, "traced_steps": 2}


def read(path):
    with open(os.path.join(REPO, path)) as f:
        return json.load(f)


def make_tiny(tmp_path):
    spec = read("BENCHMARK.json")
    base = read("benchmark/configs/vitb_512_cityscale.json")
    config = {**base["config"], **TINY_CONFIG}
    (tmp_path / "benchmark" / "traffic").mkdir(parents=True)
    (tmp_path / "cfg.json").write_text(json.dumps({"published": VIT_T, "config": config}))
    (tmp_path / "cfg_eager.json").write_text(json.dumps(
        {"published": VIT_T, "config": {**config, "FUSED_ENCODER": False}}))
    for name, mix in (("tiny_region", REGION_MIX), ("tiny_train", TRAIN_MIX)):
        (tmp_path / "benchmark" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    spec["configs"] = [{"name": "tiny", "file": "cfg.json"},
                       {"name": "tiny_eager", "file": "cfg_eager.json"}]
    spec["workloads"] = [
        {"name": "region.vitb_512", "config": "tiny", "traffic": "tiny_region", "chips": 1},
        {"name": "region.vitb_512.eager", "config": "tiny_eager", "traffic": "tiny_region",
         "chips": 1},
        {"name": "train.vith_256", "config": "tiny", "traffic": "tiny_train", "chips": 1}]
    return spec, str(tmp_path)
