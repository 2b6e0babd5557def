"""Region-inference CLI (counterpart of sam_road_tpu/cli/infer.py, with the
same flags and outputs, plus --device).

    python -m sam_road_tpu_torch.cli.infer --config configs/toponet_vitb_512_cityscale.yaml
        --checkpoint CKPT [--output_dir NAME] [--data_root DIR] [--max_tiles N]
        [--device cuda|cpu]

Per test tile of the config's dataset: the tiled engine
(inference/engine.py, tile i + 1's phase 1 dispatched before tile i's host
half), then under ./save/NAME (or ./save/infer_<timestamp>) with the config
as config.yaml: mask/{id}_road.png and mask/{id}_itsc.png, viz/{id}.png (the
graph over the tile), graph/{id}.p (the sat2graph dict the metrics read;
SpaceNet nodes flipped to its ground-truth frame) and inference_time.txt.

--checkpoint is picked by content (models/convert.py::load_weights): this
package's ckpt_epoch_N.pt loads strictly; a SAM .pth or SAMRoad .ckpt goes
through the pos-embed resize and the name-and-shape overlay onto a model
initialised with init_random(seed 0). A JAX orbax directory raises.
--device cuda (the default) raises when torch sees no GPU. Returns the
output directory. The config's TRACE_DIR, where set, writes a Chrome trace
of the tile loop there (utils/profiling.py::maybe_trace), with the engine's
spans; each tile's line prints its last_timings.

Several cards, one process (inference/engine.py): DP_SHARDS > 1 bands each
tile's patch grid over the first DP_SHARDS visible CUDA devices (masks
bit-equal to one device's); SP_SHARDS >= 1 shards every patch's encoder
tokens over SP_SHARDS devices (SP_SHARDS 1: the SP machinery on one
device). The two together raise, as the JAX CLI asserts. Where fewer CUDA
devices are visible than asked for, the CLI raises and names the count
(the JAX CLI prints and runs on one device).
"""

from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--data_root", default=".")
    parser.add_argument("--max_tiles", type=int, default=0, help="limit tile count (0 = all)")
    parser.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs an NVIDIA GPU and torch sees none; "
                           "pass --device cpu to run on the CPU")

    from sam_road_tpu_torch.config import create_output_dir_and_save_config, load_config
    from sam_road_tpu_torch.data.dataset import read_rgb_img
    from sam_road_tpu_torch.data.partitions import (
        cityscale_data_partition,
        spacenet_data_partition,
    )
    from sam_road_tpu_torch.data.png import write_png
    from sam_road_tpu_torch.graph.convert import convert_to_sat2graph_format
    from sam_road_tpu_torch.inference.engine import TiledInferenceEngine
    from sam_road_tpu_torch.models.convert import load_weights
    from sam_road_tpu_torch.utils.profiling import maybe_trace
    from sam_road_tpu_torch.utils.viz import visualize_image_and_graph

    config = load_config(args.config)
    mesh = None
    dp_shards, sp_shards = int(config.DP_SHARDS or 0), int(config.SP_SHARDS or 0)
    if dp_shards > 1 and sp_shards >= 1:
        raise ValueError("DP_SHARDS and SP_SHARDS are mutually exclusive (spatial patch "
                         "banding vs token-row sharding of one patch)")
    if dp_shards > 1 or sp_shards >= 1:
        from sam_road_tpu_torch.parallel import make_mesh

        want = max(dp_shards, sp_shards)
        visible = torch.cuda.device_count() if device.type == "cuda" else 0
        if visible < want:
            raise RuntimeError(f"{'DP' if dp_shards > 1 else 'SP'}_SHARDS={want} needs {want} "
                               f"CUDA devices, but {visible} are visible")
        mesh = make_mesh(want)
        kind = "patch grid" if dp_shards > 1 else "encoder token grid (sequence parallel)"
        print(f"sharding the {kind} over {want} devices")
    model, mismatched = load_weights(args.checkpoint, config)
    if mismatched:
        print(f"warning: {len(mismatched)} params not found in checkpoint")

    if config.DATASET == "cityscale":
        _, _, test_img_indices = cityscale_data_partition()
        rgb_pattern = os.path.join(args.data_root, "cityscale/20cities/region_{}_sat.png")
    else:
        _, _, test_img_indices = spacenet_data_partition(
            os.path.join(args.data_root, "spacenet/data_split.json"))
        rgb_pattern = os.path.join(args.data_root, "spacenet/RGB_1.0_meter/{}__rgb.png")
    if args.max_tiles:
        test_img_indices = test_img_indices[:args.max_tiles]

    output_dir = create_output_dir_and_save_config(
        "./save/infer", config,
        specified_dir=f"./save/{args.output_dir}" if args.output_dir else None)
    for sub in ("mask", "viz", "graph"):
        os.makedirs(os.path.join(output_dir, sub), exist_ok=True)

    engine = TiledInferenceEngine(config, model, device, mesh=mesh)
    # every tile is read first: infer_tiles dispatches the next one early
    imgs = [read_rgb_img(rgb_pattern.format(i)) for i in test_img_indices]

    total_inference_seconds = 0.0
    loop_start = time.time()
    # TRACE_DIR: a Chrome trace of the loop, the engine's spans in it
    with maybe_trace(config.TRACE_DIR or None):
        for img_id, img, result in zip(test_img_indices, imgs, engine.infer_tiles(imgs)):
            print(f"Processing {img_id}", flush=True)
            pred_nodes, pred_edges, itsc_mask, road_mask = result
            total_inference_seconds = time.time() - loop_start

            write_png(os.path.join(output_dir, "mask", f"{img_id}_road.png"), road_mask)
            write_png(os.path.join(output_dir, "mask", f"{img_id}_itsc.png"), itsc_mask)

            img_size = img.shape[0]
            viz_img = visualize_image_and_graph(img, pred_nodes / img_size, pred_edges, img_size)
            write_png(os.path.join(output_dir, "viz", f"{img_id}.png"), viz_img[..., ::-1])

            if config.DATASET == "spacenet":
                # (r, c) -> the SpaceNet ground-truth frame
                pred_nodes = np.stack([img_size - pred_nodes[:, 0], pred_nodes[:, 1]], axis=1)
            large_map = convert_to_sat2graph_format(pred_nodes, pred_edges)
            with open(os.path.join(output_dir, "graph", f"{img_id}.p"), "wb") as f:
                pickle.dump(large_map, f)
            print(f"Done for {img_id}. timings={engine.last_timings}", flush=True)

    time_txt = f"Inference completed for {args.config} in {total_inference_seconds} seconds."
    print(time_txt)
    with open(os.path.join(output_dir, "inference_time.txt"), "w") as f:
        f.write(time_txt)
    return output_dir


if __name__ == "__main__":
    main()
