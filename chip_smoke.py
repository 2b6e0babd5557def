"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels,
checks and times each against its plain PyTorch version at the bench
shapes, checks the fused encoder against the eager one, drives the engine
over the bench workload through the bench tool (sam_road_tpu_torch/tools/
bench.py: a 2048 px region, ViT-B at 512 px, batch 32, bf16, random
weights from a seed), checks and times K5 (forward and gradients),
takes training steps at ViT-B 512 px, batch 16, bf16, runs a region
through the eager encoder (FUSED_ENCODER off), drives the training CLI
over a generated Cityscale-format dataset with FUSED_ENCODER_TRAIN (K6:
K1-K4 under autograd), then checks K7, K8 and K10 (the PAD_FREE / WIN_*
modes) bit-equal to K1, K4 and K2 and the fused encoder in each mode
against the eager one (tools/experiment_fused_encoder.py), drives the
inference CLI over two
generated 2048 px tiles from a SAM-format checkpoint in each mode and the
calibration CLI, then checks K9 and K11-K13 (the tools' kernels; groups
bit-equal) and runs the kernel A/B and windowed-block profiling tools, then
checks K2, K3 and K10-K13 at vit_h's head_dim 80 and drives vit_h's fused
encoder and a region through it, then checks the tools' own kernels T1-T4
and runs their three tools, then checks T5-T8 and runs the block-variant
and Mosaic-probe tools, then checks T9-T13 and runs the non-dividing block
probes and the batched-product repro, showing that each path ran through
its kernels. Before phase 11, phase 16 scores the inference CLI's graphs
with the evaluation CLI (APLS and TOPO, host code: no kernel) against a
generated street-grid ground truth, with self-checks on the ground truth
itself, a degraded copy, and the native scorers against the Python ones;
phase 17 runs configs/lora_enc_r4_dec_512.yaml (LoRA rank 4, SAM's mask
decoder, the eager encoder through K5) at full width: K5 at its shapes,
the model against its fp32 plain version, a region, training steps, and
the training, calibration and inference CLIs from a SAM-format checkpoint
with the decoder's keys; phase 18 runs a region through
configs/toponet_vitl_256.yaml and configs/toponet_vitb_1024.yaml (K1-K4),
which never ran on the card before; phase 19 generates SpaceNet- and
Cityscale-format ground truth, makes its label masks with the preparation
CLI (checked against the graphs), runs the label debugger, trains
configs/toponet_vitb_256_spacenet.yaml at full width on the prepared
labels (K5 at its window and 256-token global shapes first), infers with
the trained checkpoint (K1-K4, K3 at 256 tokens) and triages the result;
phase 20 (after phase 17) drives the port over several shards: the bench
workload banded over 4 (distinct cards where 4 are visible, else cuda:0
four times; masks bit-equal to one device's, K1-K4 launched on every
shard), configs/toponet_vitb_1024.yaml token-sharded over 4 and over 1 (the
SP encoder against the fp32 eager one), DDP training steps over gloo and
NCCL against one process, and the inference CLI with SP_SHARDS /
DP_SHARDS and the training CLI under torch.distributed.run. Phase 21
runs the inference measurement tools at the bench geometry: the
phase-1, extraction / phase-2 and phase-2 profilers, the paired engine
A/B, the batch sweep and the encoder profiler, each printing its JSON line;
phase 23 then runs the engine's pipeline modes over the bench region, each
as arm B of the paired A/B tool against the whole-region path (the default
streamed phase 1 and its band, taper and upload variants, the banded
upload, fetch waves, packed arguments, device aggregation, here and on a
768 px region where it engages, and the speculative phase 2, here and on
a region where it must hit), every arm's masks, nodes and edges bit-equal
to the whole-region path's, and infer_tiles against one region at a time.
Phase 6 also checks K5's fp32 kernel, and phase 22 runs the training
measurement tools (the feed profile, the memory table, the throughput
sweep, the K5 / K6 step A/B, the TOPO profile, the checkpoint parity
report against the torch oracle), then training steps of
configs/toponet_vith_256.yaml (K5 and K6 at head_dim 80),
configs/toponet_vitl_256.yaml and configs/toponet_vitb_1024.yaml (with
and without REMAT_ENCODER), which never trained on the card before.
Phase 24 runs the synthetic example end to end at its own settings
(sam_road_tpu_torch/examples/end_to_end_synthetic.py: vit_t trained from
random weights for 4 x 150 steps through K5's head_dim-32 instance,
calibrated, inferred and scored: the loss must fall and APLS / TOPO F1
clear their floors); phase 25 runs the streamed-schedule probes at the
bench geometry (every instrumented run bit-equal to the engine's, the
bands' masks to the whole path's); phase 26 holds the fp32 training step
at ViT-B 512 px to the JAX package's committed losses and gradient norm.
Every kernel's time sits beside its bound (bytes or operations at the
card's peak rates) and, where one PyTorch call computes the same function,
that call's time.

    python3 chip_smoke.py

The last line of a passing run is {"ok": true, "device": {...}}; any failure
exits nonzero without it. Needs CUDA; never falls back to the CPU.
"""

from __future__ import annotations

import gc
import glob
import json
import math
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

from sam_road_tpu_torch.tools.bench import BENCH, REGION, calibrate

TOL = 2e-2  # |kernel - plain_fp32| <= TOL * (1 + |plain_fp32|), bf16 kernels
# K5's fp32 kernel against its plain version in fp32: the same math summed in
# another order (fp32 rounding, ~1e-6 relative), with two orders of margin
TOL_F32 = 1e-4
COS_MIN = 0.999
# the bench workload (ViT-B 512 px, batch 32, bf16, FUSED_ENCODER, a 2048 px
# region): sam_road_tpu_torch/tools/bench.py's, which phase 5 runs
BENCH_PER_BATCH = {"ln_dense": 12, "window_attention_rows_grid": 8, "attention_relpos_rows": 4,
                   "proj_ln_mlp_residual": 12}
BENCH_RUNS = 3  # phase 5's timed runs
SEED = 0  # random weights (torch.Generator) for phases 4, 5, 7 and 8
TRAIN = dict(  # configs/toponet_vitb_512_cityscale.yaml's training geometry
    DATASET="cityscale", SAM_VERSION="vit_b", PATCH_SIZE=512, BATCH_SIZE=16,
    COMPUTE_DTYPE="bfloat16", TOPO_SAMPLE_NUM=512, MAX_NEIGHBOR_QUERIES=16,
    FLASH_ATTENTION=True, FUSED_ENCODER_TRAIN=False,
)
TRAIN_STEPS = 4
TRAIN_WATCH = ("image_encoder.blocks.0.attn.qkv.weight", "map_decoder.0.weight",
               "topo_net.output_proj.weight")
# phase 17: configs/lora_enc_r4_dec_512.yaml as it stands (ViT-B 512 px,
# LoRA rank 4, the SAM decoder, INFER_BATCH_SIZE 64, bf16, FUSED_ENCODER off:
# the eager encoder through K5); the parameters its training must move
LORA_CONFIG = "configs/lora_enc_r4_dec_512.yaml"
LORA_WATCH = ("image_encoder.blocks.0.attn.qkv.linear_a_q.weight",
              "image_encoder.blocks.1.attn.qkv.linear_b_v.weight",
              "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix",
              "mask_decoder.transformer.layers.0.self_attn.q_proj.weight",
              "mask_decoder.output_upscaling.0.weight", "topo_net.output_proj.weight")
LORA_CLI_WATCH = ("image_encoder.blocks.1.attn.qkv.linear_b_q.weight",
                  "mask_decoder.output_hypernetworks_mlps.1.layers.0.weight")
LORA_CLI_STEPS = 4
LORA_FLASH_CASES = (("LoRA region window 14x14", 64 * 9, 14, 12, 64),  # K5 at batch 64
                    ("LoRA region global 32x32", 64, 32, 12, 64))
# phase 18: one region through each config as it stands, with its launches
# per batch (FUSED_ENCODER: K1-K4; vit_l 24 blocks, 4 global)
REGION_CONFIGS = {
    "configs/toponet_vitl_256.yaml": {"ln_dense": 24, "window_attention_rows_grid": 20,
                                      "attention_relpos_rows": 4, "proj_ln_mlp_residual": 24},
    "configs/toponet_vitb_1024.yaml": {"ln_dense": 12, "window_attention_rows_grid": 8,
                                       "attention_relpos_rows": 4, "proj_ln_mlp_residual": 12},
}
EAGER_REGION = 1024  # phase 8: BENCH with FUSED_ENCODER off
KERNEL_META = {  # wrapper -> (CUDA source, the TPU kernel it replaces)
    "ln_dense": ("sam_road_tpu_torch/csrc/gemm.cu", "sam_road_tpu/ops/fused_ln.py:61"),
    "window_attention_rows_grid": ("sam_road_tpu_torch/csrc/window_attention.cu",
                                   "sam_road_tpu/ops/fused_block.py:308"),
    "attention_relpos_rows": ("sam_road_tpu_torch/csrc/relpos_attention.cu",
                              "sam_road_tpu/ops/attention.py:188"),
    "proj_ln_mlp_residual": ("sam_road_tpu_torch/csrc/gemm.cu", "sam_road_tpu/ops/fused_ln.py:188"),
    "fused_attention": ("sam_road_tpu_torch/csrc/relpos_attention.cu",
                        "sam_road_tpu/ops/attention.py:265"),
}
# phase 9: the training CLI over the flagship config's keys plus these
FLAGSHIP = "configs/toponet_vitb_512_cityscale.yaml"
CLI = dict(IMAGE_SIZE=1024, FUSED_ENCODER_TRAIN=True, TRAIN_EPOCHS=1, DATA_WORKER_NUM=4,
           VAL_VIZ_COUNT=4)
CLI_STEPS = 4  # the loader's steady rate is phase 22's feed tool's to measure
REMAT_STEPS = 2  # the REMAT_ENCODER runs only read peak memory
GRAD_COS_MIN = 0.99
K6_META = {  # K6 wrapper -> (the kernel its forward launches, its CUDA source, the JAX custom_vjp)
    "ln_dense_d": ("ln_dense", "sam_road_tpu_torch/csrc/gemm.cu",
                   "sam_road_tpu/ops/fused_ln.py:327"),
    "ln_dense_bias_d": ("ln_dense", "sam_road_tpu_torch/csrc/gemm.cu",
                        "sam_road_tpu/ops/fused_ln.py:347"),
    "proj_ln_mlp_residual_d": ("proj_ln_mlp_residual", "sam_road_tpu_torch/csrc/gemm.cu",
                               "sam_road_tpu/ops/fused_ln.py:381"),
    "window_attention_rows_grid_d": ("window_attention_rows_grid",
                                     "sam_road_tpu_torch/csrc/window_attention.cu",
                                     "sam_road_tpu/ops/fused_block.py:445"),
    "attention_relpos_rows_d": ("attention_relpos_rows",
                                "sam_road_tpu_torch/csrc/relpos_attention.cu",
                                "sam_road_tpu/ops/attention.py:242"),
}
PEAK_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA's data sheet)
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
PEAK_FP32 = 67e12  # fp32 outside the tensor cores (T9-T12's elementwise work)
PEAK_TF32X3 = 495e12 / 3  # fp32-accurate products as three TF32 ones (K5's fp32 kernel)
K10_META = {  # phase 10 kernel -> (CUDA source, the TPU kernel it replaces)
    "ln_dense_padded": ("sam_road_tpu_torch/csrc/gemm.cu", "sam_road_tpu/ops/fused_ln.py:126"),
    "proj_ln_mlp_residual_grid": ("sam_road_tpu_torch/csrc/gemm.cu",
                                  "sam_road_tpu/ops/fused_ln.py:258"),
    "window_attention_rows_grid_rolled": ("sam_road_tpu_torch/csrc/window_attention.cu",
                                          "sam_road_tpu/ops/fused_block.py:256"),
    "window_attention_rows_grid_gbatch": ("sam_road_tpu_torch/csrc/window_attention.cu",
                                          "sam_road_tpu/ops/fused_block.py:281"),
}
# phase 10: the inference CLI at the bench geometry in each encoder mode,
# with its launches per batch of 32 patches
INFER_TILES = 2
INFER_MODES = {
    "default": ({}, {"ln_dense": 12, "window_attention_rows_grid": 8,
                     "attention_relpos_rows": 4, "proj_ln_mlp_residual": 12}),
    "pad_free": ({"PAD_FREE": True}, {
        "ln_dense": 4, "ln_dense_padded": 8, "proj_ln_mlp_residual": 4,
        "proj_ln_mlp_residual_grid": 8, "window_attention_rows_grid": 8,
        "attention_relpos_rows": 4}),
    "pad_free_g4": ({"PAD_FREE": True, "WIN_GROUP_BATCH": 4}, {
        "ln_dense": 4, "ln_dense_padded": 8, "proj_ln_mlp_residual": 4,
        "proj_ln_mlp_residual_grid": 8, "window_attention_rows_grid_gbatch": 8,
        "attention_relpos_rows": 4}),
    "rolled": ({"WIN_ROLLED_ROWS": True}, {
        "ln_dense": 12, "window_attention_rows_grid_rolled": 8, "attention_relpos_rows": 4,
        "proj_ln_mlp_residual": 12}),
}
# phase 16: cli.evaluate over phase 10's graphs. Each INFER tile's ground
# truth is a street grid (first row / column, last, spacing in px): over the
# whole first tile at an arterial spacing (256 px, 256 m at Cityscale's
# 1 m/px; against a 128 px grid the native APLS of phase 10's graph takes
# more than twice as long, 80-95 s a tile), and
# tests/test_metrics.py::grid_adj's coarse grid on the second, where the
# Python APLS runs (seconds there, minutes on a full-tile grid). The
# degraded copy drops the EVAL_DROPS edges nearest the region's centre.
EVAL_GRIDS = ((32, 2032, 256), (300, 1200, 300))
EVAL_DROPS = 3
EVAL_APLS_MIN, EVAL_TOPO_MIN = 0.97, 0.98  # ground truth against itself (tests/test_metrics.py)
TOOL_META = {  # phase 11 kernel -> (CUDA source, the TPU kernel it replaces)
    "ln_mlp_residual": ("sam_road_tpu_torch/csrc/gemm.cu", "sam_road_tpu/ops/fused_ln.py:423"),
    "window_attention_rows": ("sam_road_tpu_torch/csrc/window_attention.cu",
                              "sam_road_tpu/ops/fused_block.py:135"),
    "window_attention_relpos": ("sam_road_tpu_torch/csrc/window_attention.cu",
                                "sam_road_tpu/ops/fused_block.py:570"),
    "window_attention_relpos_batched": ("sam_road_tpu_torch/csrc/window_attention.cu",
                                        "sam_road_tpu/ops/fused_block.py:524"),
}
# phase 11: the tools' flagship geometry (tools/experiment_fused_ln.py) and
# their timing loops; every variant or stage runs 1 + rounds * iters times
TOOL_SHAPES = dict(tokens=32 * 1024, dim=768, windows=32 * 9, win=14, heads=12)
AB_LOOP = dict(iters=10, rounds=4)
PROFILE_LOOP = dict(iters=20, rounds=5)
# phase 12: vit_h at 256 px (configs/toponet_vith_256.yaml, full width and
# depth, FUSED_ENCODER, batch 64, 16 patches per edge), head_dim 80
VITH_CONFIG = "configs/toponet_vith_256.yaml"
VITH_PER_BATCH = {"ln_dense": 32, "window_attention_rows_grid": 28, "attention_relpos_rows": 4,
                  "proj_ln_mlp_residual": 32}
# phase 13: the tools' own kernels (T1-T4) at their tools' shapes, and the
# timing loops the three tools run with
T_META = {  # kernel -> (CUDA source, the TPU kernel it replaces)
    "diag_attn": ("sam_road_tpu_torch/csrc/relpos_attention.cu",
                  "tools/experiment_group_window.py:102"),
    "window_attn_kernel1": ("sam_road_tpu_torch/csrc/window_attention.cu",
                            "tools/experiment_window_attn.py:76"),
    "window_attn_grouped": ("sam_road_tpu_torch/csrc/window_attention.cu",
                            "tools/experiment_window_attn.py:108"),
    "sel_attention": ("sam_road_tpu_torch/csrc/window_attention.cu",
                      "tools/experiment_relpos_kernel.py:85"),
}
# phase 14: T5-T8 at their tools' shapes, and the loops of their two tools.
# T5 runs relpos_attention.cu's MODE_TABLE on the global grid (its first
# variant) and K13's mode of window_attention.cu on a window.
T58_META = {  # kernel -> (CUDA source, the TPU kernel it replaces)
    "inker_attention": ("sam_road_tpu_torch/csrc/relpos_attention.cu",
                        "tools/experiment_block_variants.py:96"),
    "merge_dense": ("sam_road_tpu_torch/csrc/gemm.cu", "tools/probe_mosaic.py:40"),
    "batched_dot": ("sam_road_tpu_torch/csrc/probes.cu", "tools/probe_mosaic.py:74"),
    "lane_slice": ("sam_road_tpu_torch/csrc/probes.cu", "tools/probe_mosaic.py:101"),
}
# phase 15: T9-T13 at their tools' shapes, and the two tools. T9 / T10 are
# csrc/probes.cu's row_block_affine, T11 / T12 its window_colsum, T13 its
# batched_nt in two launch shapes.
T913_META = {  # kernel -> (CUDA source, the TPU kernel it replaces)
    "nondiv_read_write": ("sam_road_tpu_torch/csrc/probes.cu", "tools/probe_nondiv_blocks.py:40"),
    "nondiv_out_exact": ("sam_road_tpu_torch/csrc/probes.cu", "tools/probe_nondiv_blocks.py:73"),
    "inkernel_pad_loop": ("sam_road_tpu_torch/csrc/probes.cu",
                          "tools/probe_nondiv_blocks.py:115"),
    "oversized_sublane_block": ("sam_road_tpu_torch/csrc/probes.cu",
                                "tools/probe_nondiv_blocks.py:170"),
    "batched_nt": ("sam_road_tpu_torch/csrc/probes.cu", "tools/repro_aot_crash.py:50"),
}
T58_LIBRARY = {  # T7, T8 -> the PyTorch expression timed as its library_ms
    "batched_dot": "torch.bmm(q, q.transpose(1, 2)).amax(-1)",
    "lane_slice": "torch.bmm(h0, h1.transpose(1, 2)).amax(-1), the heads sliced first",
}
T913_LIBRARY = {  # kernel -> the PyTorch expression timed as its library_ms
    "nondiv_read_write": "F.pad(x, rows) + 1", "nondiv_out_exact": "x * 2",
    "inkernel_pad_loop": "F.pad(x, cols).view(B, R, nJ, win, C).sum(3)",
    "oversized_sublane_block": "F.pad(x, cols).view(B, R, nJ, win, C).sum(3)",
    "batched_nt": "torch.bmm(a, b.transpose(1, 2))",
}
# T13 beyond the tool's [12, 256, 64]: N 196 (a 14 x 14 window: 8-byte
# stores), and 64 heads (1024 items: the looped grid's blocks walk ~8 each)
T13_MORE = ((12, 196), (64, 256))
# phase 19: labels to a trained model. SPACENET_CONFIG as it stands (ViT-B
# 256 px, batch 64, bf16, FLASH_ATTENTION: the eager encoder through K5 in
# training, FUSED_ENCODER in inference) over a generated SpaceNet-format
# tree of SPACENET_SPLIT tiles; its launches a forward
SPACENET_CONFIG = "configs/toponet_vitb_256_spacenet.yaml"
SPACENET_SPLIT = {"train": 6, "validation": 2, "test": 4}
# enough steps that the loader's producer threads still run after its
# buffer (4 in its queue, one in each of 4 workers' hands) is spent: 3
# steps at its steady rate
SPACENET_STEPS = 12
SPACENET_PER_FORWARD = {"fused_attention": 12}
SPACENET_INFER_PER_BATCH = {"ln_dense": 12, "window_attention_rows_grid": 8,
                            "attention_relpos_rows": 4, "proj_ln_mlp_residual": 12}
# phase 20: several shards. DP: the bench workload's patch rows banded over
# DP_N shards of BENCH's batch / DP_N patches (4 distinct cards where 4 are
# visible, else cuda:0 four times); SP: SP_CONFIG's 64 token rows over SP_N
# shards and over 1; DDP: TRAIN's global batch over 2 gloo ranks on cuda:0
# and over every card through NCCL, against one process, DDP_STEPS steps
DP_N = 4
SP_CONFIG = "configs/toponet_vitb_1024.yaml"
SP_N = 4
SP_ENCODER_CHUNK = 2  # images a call of the fp32 eager reference encoder
DDP_STEPS = 2
DDP_LOSS_RTOL, DDP_GRAD_RTOL = 2e-3, 1e-2
# SP against one device: tests/test_multichip_inference.py's 1 level is fp32's; here two
# bf16 encoders (plain-torch attention against K1-K4, features at cosine 0.9999) feed the
# decoder, and a logit one bf16 step apart moves a sigmoid score by up to about 2 levels
SP_CLI_MAX_LEVELS = 2
# phase 21: the inference measurement tools at the bench geometry, few rounds
PROFILE_ROUNDS = 3
SWEEP_BATCHES = (16, 32, 64)
SWEEP_RUNS = 1
AB_B = {"FUSED_ENCODER": False}
# phase 23: the engine's pipeline modes on the bench region, each arm B of a
# paired same-process A/B (sam_road_tpu_torch/tools/abtest_engine.py) against
# A, the whole-region path; every arm's masks, nodes and edges bit-equal to A's
PIPELINE_A = {"INFER_STREAM_PHASE1": False}
PIPELINE_ARMS = {
    "stream_4_taper": {},  # the default config
    "stream_2_even": {"INFER_STREAM_BANDS": 2, "INFER_STREAM_TAPER": False},
    "concurrent_upload": {"INFER_STREAM_SERIAL_UPLOAD": False},
    "upload_bands_4": {"INFER_STREAM_PHASE1": False, "INFER_UPLOAD_BANDS": 4},
    "fetch_waves_2": {"INFER_P2_FETCH_WAVES": 2},
    "pack_args": {"INFER_P2_PACK_ARGS": True},
    "device_agg": {"INFER_P2_DEVICE_AGG": True},
    "speculative": {"INFER_P2_SPECULATIVE": True},
}
# paired rounds, each every arm and then A once (abtest_engine.arms); the
# default config's run before them is the phase's one warm run, so the arms
# take none of their own (warm=False)
PIPELINE_ROUNDS = 2
# the device aggregation's second region: at the bench's vertex density its
# unique edges fit the uint16 ids (E_pad <= 65535), which the bench region's
# very likely exceed
AGG_REGION = 768
# infer_tiles (tile i's host half while tile i + 1's phase 1 runs) over
# TILES regions of TILE px against the same regions one by one
TILES, TILE = 3, 1024
BLOCK_LOOP = dict(iters=10, reps=3)
PROBE_REPS = 20
GROUP_WINDOW_LOOP = dict(iters=10, rounds=4)
WINDOW_ATTN_LOOP = dict(iters=30, reps=3)
RELPOS_LOOP = dict(iters=20, reps=3)
# phase 22: the training measurement tools at full width, their steps,
# rounds and batches cut to fit the run; then the training configurations
# that never ran on the card, at their own geometry (3 steps or more each)
# 2 timed fed steps a worker count: a smoke check, since at
# 4-8 workers the batches are made before the timed steps (the steady rate
# takes the tool's 16)
FEED_RUN = dict(fed_batches=3, device_steps=5)
TRAIN_SWEEP_STEPS = 2
FUSED_AB = dict(steps=4, rounds=2)
VITH_CONFIG_AB = dict(steps=2, rounds=1)  # with the warm-up, 3 steps an arm
VITL_CONFIG = "configs/toponet_vitl_256.yaml"
VITB_1024_CONFIG = "configs/toponet_vitb_1024.yaml"
MEMORY_1024_STEPS = 2  # after the warm step: 3 steps a configuration


def phase(name):
    print(f"== {name}", flush=True)


def print_ptxas(log_path: str, kernels) -> None:
    """ptxas's registers, spills and shared memory (nvcc --ptxas-options=-v,
    in the build log) of every instance of the named kernels, demangled."""
    import re

    if not os.path.exists(log_path):
        print(f"no ptxas log at {log_path}", flush=True)
        return
    name = None
    for line in open(log_path).read().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = subprocess.run(["c++filt", m.group(1)], capture_output=True, text=True,
                                  timeout=60).stdout.strip()
        elif name and any(k in name for k in kernels) and re.search(
                r"registers|spill|stack|smem", line):
            short = name.replace("(anonymous namespace)::", "").removeprefix("void ")
            print(f"ptxas {short.split('(')[0]}: {line.split(':', 1)[-1].strip()}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=10, warmup=2):
    """Median CUDA-event time of one call, in ms."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int = 50):
    """Device time of the kernels one call of fn launches, in ms, from
    torch.profiler's CUDA kernel events alone (a launch-bound kernel's
    CUDA-event time is mostly its host-side launch): for each kernel name,
    the mean duration of its recorded events times its launches a call
    (events / reps, rounded; unrounded under one half), so that events the
    profiler drops do not lower it (a drop is printed); None where the
    profiler recorded no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.count == 0:
            continue
        per_call = round(e.count / reps) or e.count / reps
        if isinstance(per_call, int) and e.count != per_call * reps:
            print(f"device_ms: the profiler recorded {e.count} events of {e.key[:60]} in "
                  f"{reps} calls (expected {per_call * reps})", flush=True)
        total += e.self_device_time_total / e.count * per_call
    return total / 1e3 if total > 0 else None


def host_us(fns, reps: int = 100, rounds: int = 5, dev: str = "cuda") -> list:
    """Microseconds a call of each of fns on the host's clock: in each
    round, for each fn in turn, time.perf_counter over reps calls launched
    back to back and one synchronise, inside the span (a call whose kernel
    outlasts its host side reads the kernel's rate); the median over the
    rounds. The fns take turns, so a drift of the shared host reaches each
    alike."""
    import torch

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    for fn in fns:
        fn()
    sync()
    times = [[] for _ in fns]
    for _ in range(rounds):
        for fn, t_fn in zip(fns, times):
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            sync()
            t_fn.append((time.perf_counter() - t) / reps * 1e6)
    return [statistics.median(t_fn) for t_fn in times]


def with_device_time(row: dict, fn, dev: str = "cuda") -> dict:
    """Add to a timing row `device_ms` (the profiler's kernel time of one
    call of fn; None off the card) and the bound's share of the CUDA-event
    time (`bound_share`) and of the kernel time (`device_bound_share`)."""
    d = device_ms(fn) if dev == "cuda" else None
    row.update(device_ms=d, bound_share=row["bound_ms"] / row["ms"],
               device_bound_share=None if d is None else row["bound_ms"] / d)
    return row


def fmt_device(row: dict) -> str:
    d = "none" if row["device_ms"] is None else f"{row['device_ms']:.4f}"
    share = "none" if row["device_bound_share"] is None else f"{row['device_bound_share']:.3f}"
    return (f"device_ms {d} (profiler kernel events, mean of 50 calls) bound_share "
            f"{row['bound_share']:.3f} (of ms) {share} (of device_ms)")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(flops: float, moved: float, peak: float = PEAK_FLOPS) -> dict:
    """The least time the card could take: the larger of the operations at
    their type's peak (the bf16 tensor cores unless `peak` says otherwise)
    and the bytes (each input read once, each output written once) at the
    HBM peak."""
    t_ops, t_bytes = flops / peak * 1e3, moved / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes
                else "bytes", flops=flops, bytes=moved)


def kernel_flops(name: str, args) -> float:
    """Operations of one call (multiply-adds count 2) at these inputs."""
    if name.startswith("ln_dense"):  # x [.., C], w [F, C]
        x, w = args[0], args[3]
        return 2.0 * x.numel() * w.shape[0]
    if name.startswith("proj_ln_mlp_residual"):  # x [.., C], w1 [4C, C]
        x, w1 = args[0], args[6]
        C = x.shape[-1]
        return 2.0 * (x.numel() // C) * (C * C + 2 * C * w1.shape[0])
    if name.startswith("window_attention_rows_grid"):  # bh [B, nI, nJ, heads, N, win]
        qkv, bh = args[0], args[2]
        B, nI, nJ, heads, N, _ = bh.shape
        return 4.0 * B * nI * nJ * heads * N * N * (qkv.shape[-1] // 3 // heads)
    if name == "ln_mlp_residual":  # x [M, C], w1 [4C, C]
        return 4.0 * args[0].numel() * args[3].shape[0]
    if name == "window_attention_rows":  # qkv [nW, N, 3C], bh [nW, heads, N, win]
        nW, heads, N, _ = args[1].shape
        return 4.0 * nW * heads * N * N * (args[0].shape[-1] // 3 // heads)
    if name.startswith("window_attention_relpos"):  # + the bias rows from the tables
        q, rh = args[0], args[-2]  # q [nW, heads, N, hd] or qkv [nW, N, 3C]; rh [2 win - 1, hd]
        hd, win = rh.shape[1], (rh.shape[0] + 1) // 2
        nW, N = q.shape[0], q.shape[-2]
        heads = q.shape[1] if q.dim() == 4 else q.shape[-1] // 3 // hd
        return 4.0 * nW * heads * N * N * hd + 4.0 * nW * heads * N * win * hd
    if name.startswith("attention_relpos_rows"):  # q [B, heads, N, hd]
        q = args[0]
        return 4.0 * q.shape[0] * q.shape[1] * q.shape[2] ** 2 * q.shape[3]
    if name.startswith("fused_attention"):  # q, k [B, heads, N, D], v [.., hd]
        q, v = args[0], args[2]
        return 2.0 * q.shape[0] * q.shape[1] * q.shape[2] ** 2 * (q.shape[3] + v.shape[3])
    if name.startswith("window_attn_"):  # T2 / T3: q, k [BH, N, D], v [BH, N, dv]
        q, v = args[0], args[2]
        return 2.0 * q.shape[0] * q.shape[1] ** 2 * (q.shape[2] + v.shape[2])
    if name == "sel_attention":  # T4: q, k, v [BH, N, hd]
        q = args[0]
        return 4.0 * q.shape[0] * q.shape[1] ** 2 * q.shape[2]
    if name == "inker_attention":  # T5: q [BH, N, hd], + the bias rows from rh, rw [N, w, hd]
        q, rh, rw = args[0], args[3], args[4]
        BH, N, hd = q.shape
        return 4.0 * BH * N * N * hd + 2.0 * BH * N * (rh.shape[1] + rw.shape[1]) * hd
    if name == "merge_dense":  # T6: x [G, NP, C], w [F, C]
        return 2.0 * args[0].numel() * args[1].shape[0]
    if name in ("batched_dot", "lane_slice"):  # T7, T8: 64-deep products of [B, N] rows
        B, N = args[0].shape[:2]
        return 2.0 * B * N * N * 64
    raise KeyError(name)


def kernel_bytes(name: str, args, out) -> int:
    """Bytes one call must move: each input read once, the output written
    once; of lane_slice's x (T8) only the two 64-column heads it reads."""
    if name == "lane_slice":
        B, N = args[0].shape[:2]
        return B * N * 128 * args[0].element_size() + nbytes(out)
    return nbytes(*args) + nbytes(out)


def library_call(name: str, args, win: int = 14, heads: int = 12):
    """One PyTorch call that computes the same function, on inputs laid out
    for it beforehand (timed as the yardstick only; the port never calls
    it), or None: F.scaled_dot_product_attention, with the rel-pos bias
    materialised as its attn_mask for the window and global kernels."""
    import torch
    import torch.nn.functional as F

    if name.startswith("window_attention_rows_grid"):
        qkv_grid, bias, bh, bw = args
        B, Hp, Wp, C3 = qkv_grid.shape
        C, N = C3 // 3, win * win
        nI, nJ = Hp // win, Wp // win
        t = (qkv_grid + bias).reshape(B, nI, win, nJ, win, 3, heads, C // heads)
        t = t.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, B * nI * nJ, heads, N, C // heads)
        q, k, v = (x.contiguous() for x in t)
        mask = (bh.reshape(-1, heads, N, win, 1) + bw.reshape(-1, heads, N, 1, win)).reshape(
            B * nI * nJ, heads, N, N).contiguous()
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    if name.startswith("attention_relpos_rows"):
        q, k, v, bh, bw = args
        Bq, hq, N, _ = q.shape
        side = bh.shape[-1]
        mask = (bh[..., :, None] + bw[..., None, :]).reshape(Bq, hq, N, side * side).contiguous()
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)
    if name.startswith("fused_attention"):
        q, k, v = args
        return lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0)
    if name == "diag_attn":  # T1: K11's function, per window
        return library_call("window_attention_rows", args, win, heads)
    # T2-T4 as [1, BH, N, D]: SDPA's fused backends take only 4-D inputs (at
    # T2's D 92, no multiple of 8, only its math path runs)
    if name.startswith("window_attn_"):  # T2 / T3: q, k 92 wide, v 64
        q, k, v = (t[None] for t in args)
        return lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0)
    if name == "sel_attention":  # T4: q pre-scaled, bias rows qh, qw
        q, k, v, qh, qw = args
        BH, N, _ = q.shape
        mask = (qh[..., :, None] + qw[..., None, :]).reshape(1, BH, N, N).contiguous()
        q, k, v = q[None], k[None], v[None]
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)
    if name.startswith(("window_attention_rows", "window_attention_relpos")):  # K11-K13
        from sam_road_tpu_torch.ops.fused_block import _split_heads, expand_rel_pos
        if name.endswith("batched"):
            q, k, v, *rows = args
        else:
            qkv, *rows = args
            q, k, v = (x.contiguous() for x in _split_heads(qkv, heads))
        if name != "window_attention_rows":  # rows are the rel-pos tables: q . R
            rows = [torch.einsum("whnc,nac->whna", q, r)
                    for r in expand_rel_pos(*rows, win, q.dtype)]
        nW, hq, N, _ = q.shape
        bh, bw = rows
        mask = (bh[..., :, None] + bw[..., None, :]).reshape(nW, hq, N, N).contiguous()
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    if name == "inker_attention":  # T5: the bias rows q.rh, q.rw spread into a mask
        q, k, v, rh, rw = args
        BH, N, _ = q.shape
        bh, bw = (torch.einsum("bnc,nac->bna", q, r) for r in (rh, rw))
        mask = (bh[..., :, None] + bw[..., None, :]).reshape(1, BH, N, N).contiguous()
        q, k, v = q[None], k[None], v[None]
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    if name == "merge_dense":  # T6: w [F, C]
        x, w = args
        return lambda: torch.matmul(x, w.t())
    if name in ("batched_dot", "lane_slice"):  # T7, T8: torch.bmm, then the row max
        x = args[0]  # T8's two heads are sliced (views) here, outside the timed call
        a, b = (x, x) if name == "batched_dot" else (x[..., :64], x[..., 64:128])
        return lambda: torch.bmm(a, b.transpose(1, 2)).amax(-1)
    if name == "nondiv_read_write":  # T9: x [B, H, W, C] padded to whole blocks of rows, + 1
        x = args[0]
        pad = -x.shape[1] % win
        return lambda: F.pad(x, (0, 0, 0, 0, 0, pad)) + 1
    if name == "nondiv_out_exact":  # T10
        x = args[0]
        return lambda: x * 2
    if name in ("inkernel_pad_loop", "oversized_sublane_block"):  # T11, T12: x [B, R, W, C]
        x = args[0]
        B, R, W, C = x.shape
        nJ = -(-W // win)
        return lambda: F.pad(x, (0, 0, 0, nJ * win - W)).view(B, R, nJ, win, C).sum(3)
    if name == "batched_nt":  # T13
        a, b = args
        return lambda: torch.bmm(a, b.transpose(1, 2))
    return None


def timing_row(name: str, args, out, kern, plain, fwd_bwd: bool = False, flops=None,
               heads: int = 12, win: int = 14, peak: float = PEAK_FLOPS) -> dict:
    """ms (kernel), plain_ms, library_ms and the bound of one call; `flops`
    where the operations do not follow from name and args alone (T1,
    T9-T13), at `peak` operations a second."""
    import torch

    ms = cuda_ms(kern)
    plain_ms = cuda_ms(plain)
    flops = kernel_flops(name, args) if flops is None else flops
    moved = kernel_bytes(name, args, out)
    lib = None if fwd_bwd else library_call(name, args, win=win, heads=heads)
    if fwd_bwd:  # + the gradient of every input, the cotangent read once
        flops, moved = 3 * flops, 2 * moved
    lib_ms = None
    if lib is not None:
        with torch.no_grad():
            lib_ms = cuda_ms(lib)
        del lib
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **bound(flops, moved, peak))


def product_alone(name: str, args):
    """For a GEMM kernel (K1, K4, K9): a call of torch.matmul (cuBLAS) on the
    same bf16 products alone, without the LN, the epilogues or the launches'
    order: a yardstick for the main loop, not the same function (the
    `kernels` line's library_ms stays None). None for any other kernel."""
    import torch

    def mm(a, w):
        out = torch.empty((a.shape[0], w.shape[0]), dtype=a.dtype, device=a.device)
        return lambda: torch.matmul(a, w.t(), out=out)

    if name.startswith("ln_dense"):  # x, ln_s, ln_b, w, bias
        prods = [mm(args[0], args[3])]
    elif name == "proj_ln_mlp_residual":  # x, a, wp, bp, ln_s, ln_b, w1, b1, w2, b2
        mid = torch.empty((args[0].shape[0], args[6].shape[0]), dtype=args[0].dtype,
                          device=args[0].device)
        prods = [mm(args[1], args[2]), mm(args[0], args[6]), mm(mid.zero_(), args[8])]
    elif name == "ln_mlp_residual":  # x, ln_s, ln_b, w1, b1, w2, b2
        mid = torch.empty((args[0].shape[0], args[3].shape[0]), dtype=args[0].dtype,
                          device=args[0].device)
        prods = [mm(args[0], args[3]), mm(mid.zero_(), args[5])]
    else:
        return None

    def run():
        for p in prods:
            p()
    return run


def with_product_alone(row: dict, name: str, args) -> str:
    """Add `product_alone_cublas_ms` to a GEMM kernel's row; the text to
    print."""
    run = product_alone(name, args)
    if run is None:
        return ""
    row["product_alone_cublas_ms"] = cuda_ms(run)
    return (f" product alone (cuBLAS), not the same function: "
            f"{row['product_alone_cublas_ms']:.4f} ms")


def check_kernels(B: int, dev: str = "cuda", grid: int = 32):
    """Each of K1-K4 against its plain version at ViT-B's widths for B
    patches of a grid x grid token grid (K2's padded to whole 14 x 14
    windows): phase 3 at the bench's 32 x 32, phase 19 at the SpaceNet
    config's 16 x 16. K2's and K3's rows also carry the profiler's kernel
    time and the bound's share."""
    import torch

    from sam_road_tpu_torch.ops import attention, fused_block, fused_ln

    gen = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    C, heads, hd, win = 768, 12, 64, 14
    M = B * grid * grid
    pad = (win - grid % win) % win
    gp = grid + pad
    nw = gp // win
    x = rn(M, C)
    s1, b1n = (1 + rn(C, scale=0.1)), rn(C, scale=0.1)
    wqkv, bqkv = rn(3 * C, C, scale=C ** -0.5), rn(3 * C, scale=0.1)
    qkv_grid = torch.zeros((B, gp, gp, 3 * C), dtype=bf, device=dev)
    qkv_grid[:, :grid, :grid] = rn(B, grid, grid, 3 * C)
    bh_w, bw_w = rn(B, nw, nw, heads, win * win, win), rn(B, nw, nw, heads, win * win, win)
    q, k, v = (rn(B, heads, grid * grid, hd) for _ in range(3))
    q = (q.float() * hd ** -0.5).to(bf)
    bh_g, bw_g = rn(B, heads, grid * grid, grid), rn(B, heads, grid * grid, grid)
    a = rn(M, C)
    wp, bp = rn(C, C, scale=C ** -0.5), rn(C, scale=0.1)
    s2, b2n = (1 + rn(C, scale=0.1)), rn(C, scale=0.1)
    w1, bb1 = rn(4 * C, C, scale=C ** -0.5), rn(4 * C, scale=0.1)
    w2, bb2 = rn(C, 4 * C, scale=(4 * C) ** -0.5), rn(C, scale=0.1)

    cases = {
        "ln_dense": (fused_ln.ln_dense, fused_ln.ln_dense_plain,
                     (x, s1, b1n, wqkv, None)),
        "ln_dense+bias": (fused_ln.ln_dense, fused_ln.ln_dense_plain,
                          (x, s1, b1n, wqkv, bqkv)),
        "window_attention_rows_grid": (
            lambda *t: fused_block.window_attention_rows_grid(*t, win, heads),
            lambda *t: fused_block.window_attention_rows_grid_plain(*t, win, heads),
            (qkv_grid, bqkv, bh_w, bw_w)),
        "attention_relpos_rows": (
            lambda *t: attention.attention_relpos_rows(*t, (grid, grid)),
            lambda *t: attention.attention_relpos_rows_plain(*t, (grid, grid)),
            (q, k, v, bh_g, bw_g)),
        "proj_ln_mlp_residual": (fused_ln.proj_ln_mlp_residual,
                                 fused_ln.proj_ln_mlp_residual_plain,
                                 (x, a, wp, bp, s2, b2n, w1, bb1, w2, bb2)),
    }
    results = {}
    for name, (kern, plain, args) in cases.items():
        got = kern(*args)
        torch.cuda.synchronize()
        ref = plain(*[t.float() if t is not None else None for t in args])
        err = (got.float() - ref).abs()
        max_abs = err.max().item()
        max_rel = (err / (1 + ref.abs())).max().item()
        finite = bool(torch.isfinite(got.float()).all())
        del ref, err
        row = timing_row(name, args, got, lambda: kern(*args), lambda: plain(*args))
        device = ""
        device = " " + fmt_device(with_device_time(row, lambda: kern(*args), dev))
        if dev == "cuda":
            device += with_product_alone(row, name, args)
        ok = finite and max_rel <= TOL
        print(f"kernel {name}: shape {tuple(got.shape)} max_abs_err {max_abs:.3e} "
              f"max_rel_err {max_rel:.3e} (tol {TOL}) {fmt_times(row)}{device} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"kernel {name} disagrees with its plain version")
        results[name] = dict(max_abs_err=max_abs, **row)
        del got
    return results


def fmt_times(row: dict, plain: str = "bf16") -> str:
    lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
    return (f"kernel_ms {row['ms']:.4f} plain_{plain}_ms {row['plain_ms']:.4f} library_ms {lib} "
            f"bound_ms {row['bound_ms']:.4f} ({row['bound_by']})")


# K5's shapes (label, windows or images, grid side, heads, head_dim): the
# ViT-B 512 px training batch's windows (16 images x 9 windows of 196
# tokens, D 92 padded to 96), its global grid (D 128), the 1024 px config's
# global grid (2 images, 4096 tokens, D 192), the 256 px configs' global grid
# (ViT-B and vit_l, D 96), and vit_h's windows (16 images x 4, D 108 padded
# to 112) and 256 px global grid (D 112) with the eager encoder, and
# vit_t's windows at the synthetic example's batch (16 images of 80 px: one
# 14 x 14 window each, head_dim 32, D 60 padded to 64)
FLASH_CASES = (("window 14x14", 16 * 9, 14, 12, 64), ("global 32x32", 16, 32, 12, 64),
               ("global 64x64", 2, 64, 12, 64), ("global 16x16", 16, 16, 12, 64),
               ("vit_h window 14x14", 16 * 4, 14, 16, 80), ("vit_h global 16x16", 16, 16, 16, 80),
               ("vit_t window 14x14", 16, 14, 2, 32))


def flash_cases(dev: str = "cuda", cases=FLASH_CASES, dtype=None):
    """K5's inputs at its main-path shapes, in `dtype` (bf16 unless given):
    random q, k, v [B, heads, N, hd] and rel-pos tables folded by
    models/vit.py::fold_rel_pos_qk (q~ scaled and carrying q.R columns, k~
    the exact one-hot position columns, both padded to a multiple of 16),
    and a cotangent."""
    import torch

    from sam_road_tpu_torch.models.vit import fold_rel_pos_qk

    gen = torch.Generator(device=dev).manual_seed(3)
    dtype = dtype or torch.bfloat16
    for name, B, side, heads, hd in cases:
        N = side * side

        def rn(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

        q, k, v, g = (rn(B, heads, N, hd) for _ in range(4))
        Rh, Rw = (rn(side, side, hd, scale=0.3 * hd ** -0.5) for _ in range(2))
        q, k = (t.contiguous() for t in fold_rel_pos_qk(q, k, Rh, Rw, (side, side),
                                                        hd ** -0.5))
        yield name, q, k, v, g


def check_flash_attention(dev: str = "cuda", cases=FLASH_CASES, dtype=None):
    """Phases 6 and 17: K5 against its plain version at a path's shapes
    (`cases`): the forward, and the autograd.Function's gradients against
    autograd through the plain version in fp32 on the same inputs. bf16
    inputs (the default) run relpos_attention.cu's MODE_FOLDED, within TOL;
    fp32 ones folded_attention_f32.cu, within TOL_F32, bounded by the
    TF32 tensor cores' rate over three (PEAK_TF32X3)."""
    import torch

    from sam_road_tpu_torch.ops import attention

    fp32 = dtype == torch.float32
    tol, label = (TOL_F32, "fused_attention_f32") if fp32 else (TOL, "fused_attention")
    shapes = {}
    for name, q, k, v, g in flash_cases(dev, cases, dtype):
        got = attention.fused_attention(q, k, v)
        torch.cuda.synchronize()
        ref = attention.fused_attention_plain(q.float(), k.float(), v.float())
        err = (got.float() - ref).abs()
        fwd_rel = (err / (1 + ref.abs())).max().item()
        max_abs = err.max().item()
        finite = bool(torch.isfinite(got.float()).all())
        del got, ref, err
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        attention.fused_attention(*leaves).backward(g)
        ref_leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
        attention.fused_attention_plain(*ref_leaves).backward(g.float())
        bwd_rel = max(((a.grad.float() - b.grad).abs() / (1 + b.grad.abs())).max().item()
                      for a, b in zip(leaves, ref_leaves))
        finite = finite and all(bool(torch.isfinite(t.grad.float()).all()) for t in leaves)
        del leaves, ref_leaves
        with torch.no_grad():
            out = torch.empty_like(v)
            row = timing_row("fused_attention", (q, k, v), out,
                             lambda: attention.fused_attention(q, k, v),
                             lambda: attention.fused_attention_plain(q, k, v),
                             peak=PEAK_TF32X3 if fp32 else PEAK_FLOPS)
            device = fmt_device(with_device_time(
                row, lambda: attention.fused_attention(q, k, v), dev))
        ok = finite and fwd_rel <= tol and bwd_rel <= tol
        print(f"kernel {label} {name}: q {tuple(q.shape)} v {tuple(v.shape)} "
              f"max_abs_err {max_abs:.3e} max_rel_err {fwd_rel:.3e} grad_max_rel_err "
              f"{bwd_rel:.3e} (tol {tol}) {fmt_times(row, 'fp32' if fp32 else 'bf16')} {device} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"{label} disagrees with its plain version at {name}")
        shapes[name] = dict(max_abs_err=max_abs, grad_max_rel_err=bwd_rel, **row)
    return shapes


def check_encoder(seed: int, dev: str = "cuda"):
    """Phase 4: fused encoder (kernels, bf16) against the eager encoder
    (fp32) on 4 patches; cosine similarity >= COS_MIN."""
    import torch

    from sam_road_tpu_torch.config import load_config
    from sam_road_tpu_torch.models.fast_encoder import encoder_forward_fused
    from sam_road_tpu_torch.models.sam_road import PIXEL_MEAN, PIXEL_STD, SAMRoad, init_random

    cfg = load_config(overrides={**BENCH, "FLASH_ATTENTION": False})  # fp32 eager reference
    model = init_random(SAMRoad.from_config(cfg), seed).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(2)
    p = BENCH["PATCH_SIZE"]
    rgb = torch.randint(0, 255, (4, p, p, 3), generator=gen, device=dev)
    enc = model.image_encoder
    with torch.no_grad():
        fused = encoder_forward_fused(enc, model.normalize(rgb)).float()
        enc.dtype = torch.float32
        mean = torch.tensor(PIXEL_MEAN, device=dev)
        eager = enc((rgb.float() - mean) / torch.tensor(PIXEL_STD, device=dev)).float()
        enc.dtype = torch.bfloat16
    cos = torch.nn.functional.cosine_similarity(fused.flatten(), eager.flatten(), dim=0).item()
    ok = bool(torch.isfinite(fused).all()) and cos >= COS_MIN
    print(f"encoder fused(bf16 kernels) vs eager(fp32): shape {tuple(fused.shape)} "
          f"cosine {cos:.6f} max_abs {(fused - eager).abs().max().item():.3e} "
          f"(min {COS_MIN}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("fused encoder disagrees with the eager encoder")


def bench_batches(detail: dict) -> int:
    return -(-detail["patches"] // detail["batch"])


def run_bench(dev: str = "cuda", runs: int = BENCH_RUNS):
    """Phase 5: the bench tool (sam_road_tpu_torch/tools/bench.py, which
    prints its JSON line) over its workload with seeded random weights: its
    check run must launch BENCH_PER_BATCH of each kernel a batch, its graph
    be non-empty, its masks region-sized and non-constant and the first
    batch's float mask scores and features finite. Returns the check run's
    launches."""
    from sam_road_tpu_torch.tools import bench

    d = bench.main(dev, runs=runs, seed=SEED)["detail"]
    want = {k: n * bench_batches(d) for k, n in BENCH_PER_BATCH.items()}
    if d["launches"] != want:
        raise SystemExit(f"main path launches {d['launches']}, expected {want}")
    if not d["nodes"] or not d["edges"]:
        raise SystemExit("the bench produced an empty graph")
    if d["mask_shape"] != [REGION] * 4 or any(
            lo == hi for lo, hi in d["mask_levels"].values()):
        raise SystemExit(f"the bench's masks are constant or misshapen: {d['mask_shape']} "
                         f"{d['mask_levels']}")
    if not d["scores_finite"]:
        raise SystemExit("the bench's mask scores or features hold a NaN or inf")
    print(f"bench: {d['nodes']} nodes, {d['edges']} edges, peak {d['peak_mem_gib']:.3f} GiB, "
          f"least {min(d['all_runs_s']):.3f} s, median {d['median_s']:.3f} s", flush=True)
    return d["launches"]


def run_engine(seed: int, overrides: dict, region: int, per_batch: dict, dev: str = "cuda",
               model=None, repeats: int = 2):
    """Phases 8, 12, 17 and 18: a region through the engine (`model`, or
    seeded random weights); returns the launches of the timed run, which
    must be `per_batch` launches of each kernel per batch, and prints its
    peak memory. `repeats` more runs print their timings."""
    from sam_road_tpu_torch.config import load_config
    from sam_road_tpu_torch.data.partitions import get_patch_info_one_img
    from sam_road_tpu_torch.inference.engine import TiledInferenceEngine
    from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random
    from sam_road_tpu_torch.ops import _build

    cfg = load_config(overrides=overrides)
    if model is None:
        model = init_random(SAMRoad.from_config(cfg), seed)
    img = np.random.default_rng(0).integers(0, 255, size=(region, region, 3), dtype=np.uint8)
    engine = TiledInferenceEngine(cfg, model, dev)
    # The bench tool's calibration: a warm run at thresholds 1.0 (no
    # vertices: at the default thresholds random weights put millions of
    # pixels above threshold, and the shared NMS treats every uint8 score >
    # 1.0 as immune, so extraction alone took ~171 s on the card's host),
    # then the masks' quantiles.
    t = time.time()
    calibrate(engine, img)
    print(f"engine warm run {time.time() - t:.3f} s {engine.last_timings}", flush=True)
    import torch

    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    nodes, edges, kp, road = engine.infer_one_img(img)
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    print(f"engine timed run: nodes {nodes.shape[0]} edges {edges.shape[0]} "
          f"masks {kp.shape} {road.shape} timings {engine.last_timings}; peak memory "
          f"allocated {peak / 2 ** 30:.3f} GiB", flush=True)
    print(f"engine launches {launches}", flush=True)
    for _ in range(repeats):
        engine.infer_one_img(img)
        print(f"engine repeat run timings {engine.last_timings}", flush=True)
    p, m = cfg.PATCH_SIZE, cfg.SAMPLE_MARGIN
    n_patches = len(get_patch_info_one_img(0, region, m, p, cfg.INFER_PATCHES_PER_EDGE))
    batches = -(-n_patches // cfg.INFER_BATCH_SIZE)
    want = {k: n * batches for k, n in per_batch.items()}
    if launches != want:
        raise SystemExit(f"main path launches {launches}, expected {want}")
    if nodes.shape[0] == 0 or edges.shape[0] == 0:
        raise SystemExit("engine produced an empty graph")
    if kp.shape != (region, region) or kp.max() == kp.min() or road.max() == road.min():
        raise SystemExit("engine masks are constant or misshapen")
    # the uint8 masks cannot show a NaN: check the float scores of one patch
    crop = torch.from_numpy(img[m:m + p, m:m + p]).to(dev)[None].float()
    with torch.no_grad():
        scores, emb = engine.model.infer_masks_and_features(crop, engine.encoder)
    if not (torch.isfinite(scores).all() and torch.isfinite(emb.float()).all()):
        raise SystemExit("engine mask scores or features hold a NaN or inf")
    return launches


def train_batches(n: int, seed: int = 0, geometry: dict = TRAIN):
    """n batches in collate_batch's format at the `geometry` (PATCH_SIZE,
    BATCH_SIZE, TOPO_SAMPLE_NUM, MAX_NEIGHBOR_QUERIES of TRAIN) from
    np.random.default_rng(seed): uint8 rgb and masks, about 256 graph
    points per patch (padded to the 128 bucket), TOPO_SAMPLE_NUM x
    MAX_NEIGHBOR_QUERIES pairs within range, at least one valid per
    sample."""
    from sam_road_tpu_torch.data.dataset import collate_batch

    rng = np.random.default_rng(seed)
    p, S = geometry["PATCH_SIZE"], geometry["TOPO_SAMPLE_NUM"]
    K = geometry["MAX_NEIGHBOR_QUERIES"]
    batches = []
    for _ in range(n):
        samples = []
        for _ in range(geometry["BATCH_SIZE"]):
            n_pts = int(rng.integers(224, 289))
            src = rng.integers(0, n_pts, (S, 1))
            pairs = np.stack([np.broadcast_to(src, (S, K)), rng.integers(0, n_pts, (S, K))], -1)
            valid = rng.random((S, K)) < 0.5
            valid[0, 0] = True
            samples.append(dict(
                rgb=rng.integers(0, 256, (p, p, 3)).astype(np.float32),
                keypoint_mask=(rng.random((p, p)) < 0.02).astype(np.float32),
                road_mask=(rng.random((p, p)) < 0.1).astype(np.float32),
                graph_points=rng.uniform(0, p, (n_pts, 2)).astype(np.float32),
                pairs=pairs.astype(np.int32),
                connected=(rng.random((S, K)) < 0.3) & valid,
                valid=valid,
            ))
        batches.append(collate_batch(samples))
    return batches


def run_training(seed: int, dev: str = "cuda", overrides: dict = TRAIN, model=None,
                 watch=TRAIN_WATCH, per_forward: int = 12):
    """Phases 7 and 17b: Trainer.train_epoch for TRAIN_STEPS steps and
    validate on one batch at the TRAIN geometry (the config `overrides`,
    `model` or seeded random weights); every `watch` parameter must move
    and, where the config freezes the encoder (FREEZE_ENCODER or
    ENCODER_LORA), every parameter of its group stay bit-unchanged.
    Returns the launches of that run."""
    import torch

    from sam_road_tpu_torch.config import load_config
    from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random
    from sam_road_tpu_torch.ops import _build
    from sam_road_tpu_torch.training.harness import Trainer, param_group

    cfg = load_config(overrides=overrides)
    batches = train_batches(TRAIN_STEPS, seed, overrides)
    if model is None:
        model = init_random(SAMRoad.from_config(cfg), seed)
    trainer = Trainer(cfg, model, output_dir=".", steps_per_epoch=TRAIN_STEPS, device=dev,
                      log_every=1)  # saves no checkpoint: writes nothing
    named = dict(model.named_parameters())
    frozen = {n: p.detach().clone() for n, p in named.items() if param_group(n) == "encoder"
              and (cfg.FREEZE_ENCODER or cfg.ENCODER_LORA)}
    watch = {n: named[n].detach().clone() for n in watch}
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    logs = trainer.train_epoch(batches, epoch=0)
    metrics = trainer.validate(batches[:1])
    if dev == "cuda":
        torch.cuda.synchronize()
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    for log in logs:
        print(f"train step {log['batch']}: loss {log['loss']:.6f} mask {log['mask_loss']:.6f} "
              f"topo {log['topo_loss']:.6f} grad_norm {log['grad_norm']:.6f} skipped "
              f"{log['skipped']:.0f} seconds {log['seconds']:.4f}", flush=True)
    steady = [log["seconds"] for log in logs[1:]]
    print(f"train seconds per step after the first: mean {statistics.mean(steady):.4f} "
          f"({', '.join(f'{t:.4f}' for t in steady)}); peak memory allocated "
          f"{peak / 2 ** 30:.3f} GiB", flush=True)
    print(f"validate: " + " ".join(f"{k} {v:.6f}" for k, v in metrics.items()
                                   if not k.startswith("_")), flush=True)
    moved = {n: (p.detach() - watch[n]).abs().max().item() for n, p in model.named_parameters()
             if n in watch}
    print(f"train parameters moved (max abs change): {moved}; launches {launches}", flush=True)
    if frozen:
        still = all(torch.equal(named[n], p) for n, p in frozen.items())
        print(f"frozen encoder: {len(frozen)} parameters bit-unchanged {still}", flush=True)
        if not still:
            raise SystemExit("a frozen encoder parameter changed")
    if not all(np.isfinite(log["loss"]) and np.isfinite(log["grad_norm"]) for log in logs):
        raise SystemExit("a training loss or grad_norm is not finite")
    if any(log["skipped"] for log in logs) or len(logs) != TRAIN_STEPS:
        raise SystemExit("a training step was skipped or not logged")
    if not all(v > 0 for v in moved.values()):
        raise SystemExit("training did not move every watched parameter")
    if not np.isfinite(metrics["val_loss"]):
        raise SystemExit("validation loss is not finite")
    want = per_forward * (TRAIN_STEPS + 1)  # every encoder attention of every forward
    if launches.get("fused_attention") != want:
        raise SystemExit(f"training launches {launches}, expected fused_attention {want}")
    return launches


def k6_cases(dev: str = "cuda"):
    """K6's five wrappers, each with its plain version and bf16 inputs at
    the training shapes (ViT-B 512 px, batch 16): tokens [16384, 768], the
    qkv weight [2304, 768], the window grid [16, 42, 42, 2304] with bias rows
    [16, 3, 3, 12, 196, 14], the global q, k, v [16, 12, 1024, 64] with bias
    rows [16, 12, 1024, 32]."""
    import torch

    from sam_road_tpu_torch.ops import attention, fused_block, fused_ln

    gen = torch.Generator(device=dev).manual_seed(4)
    bf = torch.bfloat16

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    B, C, heads, hd, grid, win = 16, 768, 12, 64, 32, 14
    M, gp, nw, N = B * grid * grid, 42, 3, grid * grid
    ln = (rn(M, C), 1 + rn(C, scale=0.1), rn(C, scale=0.1), rn(3 * C, C, scale=C ** -0.5))
    yield ("ln_dense_d", fused_ln.ln_dense_d,
           lambda *a: fused_ln.ln_dense_plain(*a, None), ln)
    yield ("ln_dense_bias_d", fused_ln.ln_dense_bias_d, fused_ln.ln_dense_plain,
           ln + (rn(3 * C, scale=0.1),))
    del ln
    yield ("proj_ln_mlp_residual_d", fused_ln.proj_ln_mlp_residual_d,
           fused_ln.proj_ln_mlp_residual_plain,
           (rn(M, C), rn(M, C), rn(C, C, scale=C ** -0.5), rn(C, scale=0.1),
            1 + rn(C, scale=0.1), rn(C, scale=0.1), rn(4 * C, C, scale=C ** -0.5),
            rn(4 * C, scale=0.1), rn(C, 4 * C, scale=(4 * C) ** -0.5), rn(C, scale=0.1)))
    qkv = torch.zeros((B, gp, gp, 3 * C), dtype=bf, device=dev)
    qkv[:, :grid, :grid] = rn(B, grid, grid, 3 * C)
    rows = (B, nw, nw, heads, win * win, win)
    yield ("window_attention_rows_grid_d",
           lambda *a: fused_block.window_attention_rows_grid_d(*a, win, heads),
           lambda *a: fused_block.window_attention_rows_grid_plain(*a, win, heads),
           (qkv, rn(3 * C, scale=0.5), rn(*rows), rn(*rows)))
    del qkv
    yield ("attention_relpos_rows_d",
           lambda *a: attention.attention_relpos_rows_d(*a, (grid, grid)),
           lambda *a: attention.attention_relpos_rows_plain(*a, (grid, grid)),
           (rn(B, heads, N, hd, scale=hd ** -0.5), rn(B, heads, N, hd), rn(B, heads, N, hd),
            rn(B, heads, N, grid), rn(B, heads, N, grid)))


def check_k6(dev: str = "cuda"):
    """Phase 9a: each K6 wrapper (K1-K4 forward, plain recompute backward)
    against its plain version under autograd in fp32 on the same bf16
    inputs, for a cotangent N(0, 1) / 128 (a loss's mean over the batch
    makes cotangents small): the output and every input gradient within
    TOL (1 + |ref|) elementwise, and within TOL of the tensor's largest
    |ref|. Times forward + backward (torch.autograd.grad) of the wrapper and
    of the plain version on the same bf16 tensors."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(5)
    results = {}
    for name, wrapper, plain, args in k6_cases(dev):
        leaves = [a.clone().requires_grad_() for a in args]
        got = wrapper(*leaves)
        g = (torch.randn(got.shape, generator=gen, device=dev) / 128).to(torch.bfloat16)
        got.backward(g)
        torch.cuda.synchronize()
        refs = [a.float().requires_grad_() for a in args]
        ref = plain(*refs)
        ref.backward(g.float())
        errs = {}
        for label, a, b in [("out", got, ref)] + [(f"d{i}", x.grad, y.grad)
                                                  for i, (x, y) in enumerate(zip(leaves, refs))]:
            err = (a.float() - b).abs()
            errs[label] = (err.max().item(), (err / (1 + b.abs())).max().item(),
                           err.max().item() / max(b.abs().max().item(), 1e-30),
                           bool(torch.isfinite(a.float()).all()))
            del err
        del got, ref, refs
        for t in leaves:
            t.grad = None
        row = timing_row(name, args, g, lambda: torch.autograd.grad(wrapper(*leaves), leaves, g),
                         lambda: torch.autograd.grad(plain(*leaves), leaves, g), fwd_bwd=True)
        grad_rel = max(v[1] for k, v in errs.items() if k != "out")
        grad_scaled = max(v[2] for k, v in errs.items() if k != "out")
        ok = (all(v[3] for v in errs.values()) and errs["out"][1] <= TOL and grad_rel <= TOL
              and grad_scaled <= TOL)
        print(f"kernel {name}: out {tuple(g.shape)} max_abs_err {errs['out'][0]:.3e} "
              f"max_rel_err {errs['out'][1]:.3e} grad_max_rel_err {grad_rel:.3e} "
              f"grad_max_err/max|ref| {grad_scaled:.3e} (tol {TOL}) fwd+bwd {fmt_times(row)} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"K6 {name} disagrees with its plain version: {errs}")
        results[name] = dict(max_abs_err=errs["out"][0], grad_max_rel_err=grad_rel, **row)
        del leaves, args, g
    return results


def check_train_encoder(seed: int, dev: str = "cuda"):
    """Phase 9b: the differentiable fused encoder (K6, bf16) against the
    eager encoder (K5, bf16) on 4 patches at ViT-B 512 px: output cosine >=
    COS_MIN, and cosine >= GRAD_COS_MIN of the flattened encoder gradient of
    sum(encoder(x) * R) for a fixed random R; prints the lowest per-tensor
    gradient cosine."""
    import torch
    import torch.nn.functional as F

    from sam_road_tpu_torch.config import load_config
    from sam_road_tpu_torch.models.fast_encoder import encoder_forward_fused
    from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random

    model = init_random(SAMRoad.from_config(load_config(overrides=TRAIN)), seed).to(dev)
    enc = model.image_encoder
    gen = torch.Generator(device=dev).manual_seed(6)
    p = TRAIN["PATCH_SIZE"]
    x = model.normalize(torch.randint(0, 255, (4, p, p, 3), generator=gen, device=dev))
    r = torch.randn((4, p // 16, p // 16, 256), generator=gen, device=dev)

    def run(fused):
        out = encoder_forward_fused(enc, x, differentiable=True) if fused else enc(x)
        (out.float() * r).sum().backward()
        grads = {n: q.grad.float().flatten() for n, q in enc.named_parameters()}
        enc.zero_grad(set_to_none=True)
        return out.detach().float().flatten(), grads

    out_e, g_e = run(False)
    out_f, g_f = run(True)
    cos = F.cosine_similarity(out_f, out_e, dim=0).item()
    gcos = F.cosine_similarity(torch.cat(list(g_f.values())), torch.cat(list(g_e.values())),
                               dim=0).item()
    per = {n: F.cosine_similarity(g_f[n], g_e[n], dim=0).item() for n in g_e}
    low = min(per, key=per.get)
    ok = (cos >= COS_MIN and gcos >= GRAD_COS_MIN
          and all(bool(torch.isfinite(t).all()) for t in [out_f, *g_f.values()]))
    print(f"train encoder fused (K6, bf16) vs eager (K5, bf16): output cosine {cos:.6f} "
          f"(min {COS_MIN}); encoder gradient cosine {gcos:.6f} (min {GRAD_COS_MIN}); lowest "
          f"per-tensor gradient cosine {per[low]:.6f} ({low}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise SystemExit("the differentiable fused encoder disagrees with the eager encoder")
    return dict(cosine=cos, grad_cosine=gcos, lowest=(low, per[low]))


def street_grid(lines) -> dict:
    """An axis-aligned street grid whose rows and columns lie at `lines`
    (px), as a sat2graph dict: (r, c) keys, each with its 4-neighbours."""
    adj = {}
    for i, y in enumerate(lines):
        for j, x in enumerate(lines):
            adj[(y, x)] = [(lines[i + di], lines[j + dj])
                           for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1))
                           if 0 <= i + di < len(lines) and 0 <= j + dj < len(lines)]
    return adj


def write_cityscale_fixture(root: str, size: int, spacing: int = 64, seed: int = 0):
    """The 8 Cityscale-format tiles the training CLI's --dev_run reads (the
    first 4 train and 4 test indices of cityscale_data_partition), size px
    square: an axis-aligned street grid (sat2graph (r, c) keys, spacing px
    apart, offset per tile), noisy imagery with dark roads, and road and
    keypoint masks drawn by slicing, written with png.write_png."""
    from sam_road_tpu_torch.data.partitions import cityscale_data_partition
    from sam_road_tpu_torch.data.png import write_png

    train, _, test = cityscale_data_partition()
    sat = os.path.join(root, "cityscale", "20cities")
    proc = os.path.join(root, "cityscale", "processed")
    os.makedirs(sat, exist_ok=True)
    os.makedirs(proc, exist_ok=True)
    rng = np.random.default_rng(seed)
    for n, tile in enumerate(train[:4] + test[:4]):
        lines = list(range(32 + 8 * (n % 4), size - 16, spacing))
        adj = street_grid(lines)
        with open(os.path.join(sat, f"region_{tile}_refine_gt_graph.p"), "wb") as f:
            pickle.dump(adj, f)
        lo, hi = lines[0], lines[-1]
        road = np.zeros((size, size), np.uint8)
        kp = np.zeros((size, size), np.uint8)
        for v in lines:
            road[v - 3:v + 4, lo:hi + 1] = 255
            road[lo:hi + 1, v - 3:v + 4] = 255
            for u in lines:
                kp[v - 4:v + 5, u - 4:u + 5] = 255
        rgb = rng.integers(70, 190, (size, size, 3), dtype=np.uint8)
        rgb[road > 0] //= 3
        write_png(os.path.join(sat, f"region_{tile}_sat.png"), rgb)
        write_png(os.path.join(proc, f"road_mask_{tile}.png"), road)
        write_png(os.path.join(proc, f"keypoint_mask_{tile}.png"), kp)


def run_cli(data_root: str, work: str, name: str, overrides: dict, steps: int,
            dev: str = "cuda", base: str = FLAGSHIP, args=()):
    """One `python -m sam_road_tpu_torch.cli.train` run, in process: the
    `base` config's keys plus CLI and `overrides`, --dev_run, `steps` steps
    of one epoch (and `args`), validation with panels, a checkpoint. Fails unless
    every loss is finite, no step was skipped, and the checkpoint and
    VAL_VIZ_COUNT panels exist. Returns the trainer, the config, the
    launches, the peak memory and the step times."""
    import torch

    from sam_road_tpu_torch.cli import train
    from sam_road_tpu_torch.config import load_config, read_flat_yaml, write_flat_yaml
    from sam_road_tpu_torch.ops import _build

    values = read_flat_yaml(base)
    values.update(CLI)
    values.update(overrides)
    cfg_path = os.path.join(work, f"{name}.yaml")
    write_flat_yaml(cfg_path, values)
    out = os.path.join(work, name)
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t = time.time()
    trainer = train.main(["--config", cfg_path, "--dev_run", "--steps_per_epoch", str(steps),
                          "--device", dev, "--data_root", data_root, "--output_dir", out,
                          *args])
    if dev == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    hist = trainer.history
    steady = [h["seconds"] for h in hist[1:]]
    waits = [h["data_seconds"] for h in hist[1:]]
    ckpt = os.path.join(out, "ckpt_epoch_0.pt")
    panels = glob.glob(os.path.join(out, "val_viz", "*.png"))
    print(f"cli {name}: {len(hist)} steps, seconds per step after the first: mean "
          f"{statistics.mean(steady):.4f} ({', '.join(f'{x:.4f}' for x in steady)}); loader "
          f"wait per step: mean {statistics.mean(waits):.4f} s; step minus wait: mean "
          f"{statistics.mean(steady) - statistics.mean(waits):.4f} s; first step "
          f"{hist[0]['seconds']:.4f} s (wait {hist[0]['data_seconds']:.4f}); peak memory "
          f"allocated {peak / 2 ** 30:.3f} GiB; losses "
          f"{', '.join(f'{h['loss']:.4f}' for h in hist)}; run {wall:.1f} s; launches "
          f"{launches}", flush=True)
    if len(hist) != steps or not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                                     for h in hist):
        raise SystemExit(f"cli {name}: a loss or grad_norm is not finite, or steps are missing")
    if any(h["skipped"] for h in hist):
        raise SystemExit(f"cli {name}: a training step was skipped")
    if not os.path.exists(ckpt) or len(panels) != CLI["VAL_VIZ_COUNT"]:
        raise SystemExit(f"cli {name}: checkpoint or validation panels missing: {panels}")
    return dict(trainer=trainer, config=load_config(cfg_path), launches=launches, peak=peak,
                step_s=statistics.mean(steady), wait_s=statistics.mean(waits), ckpt=ckpt)


def clean_step_seconds(trainer, seed: int, geometry: dict = TRAIN):
    """Seconds per step of `trainer` without the loader: 3 more steps over
    train_batches at its `geometry`, the mean of the last 2. Producer
    threads hold the GIL while they run, which slows the host side of a
    step the loader feeds."""
    start = len(trainer.history)
    trainer.train_epoch(train_batches(3, seed, geometry), epoch=1)
    return statistics.mean(h["seconds"] for h in trainer.history[start + 1:])


def time_loader(config, data_root: str, workers: int, batches: int):
    """Batches per second of the training BatchLoader alone."""
    from sam_road_tpu_torch.data.dataset import BatchLoader, SatMapDataset

    ds = SatMapDataset(config, is_train=True, dev_run=True, data_root=data_root)
    loader = BatchLoader(ds, int(config.BATCH_SIZE), num_batches=batches, num_workers=workers)
    t = time.perf_counter()
    n = sum(1 for _ in loader)
    rate = n / (time.perf_counter() - t)
    print(f"loader alone: {workers} workers, {n} batches of {config.BATCH_SIZE}: "
          f"{rate:.3f} batches/s ({1 / rate:.3f} s per batch)", flush=True)
    return rate


def run_training_cli(seed: int, work: str, dev: str = "cuda"):
    """Phase 9c: the training CLI over a generated 1024 px Cityscale-format
    dataset (under `work`, kept for phase 10) at ViT-B 512 px, batch 16,
    bf16: FUSED_ENCODER_TRAIN on (K6) and off (K5), each also with
    REMAT_ENCODER, then the checkpoint restored into a fresh Trainer and the
    loader timed alone. Returns the launches of the FUSED_ENCODER_TRAIN
    run."""
    import torch

    from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random
    from sam_road_tpu_torch.training.harness import Trainer, applied_updates

    t = time.time()
    data_root = os.path.join(work, "data")
    write_cityscale_fixture(data_root, CLI["IMAGE_SIZE"])
    print(f"wrote the Cityscale-format fixture in {time.time() - t:.1f} s", flush=True)
    fused = run_cli(data_root, work, "fused", {}, CLI_STEPS, dev)
    want = {k: n * CLI_STEPS for k, n in k6_per_forward(12, 4).items()}  # ViT-B
    want["fused_attention"] = 24  # the eval forward and the panels' forward, 12 each
    if fused["launches"] != want:
        raise SystemExit(f"FUSED_ENCODER_TRAIN launches {fused['launches']}, expected {want}")
    per_forward = {k: v / CLI_STEPS for k, v in fused["launches"].items()
                   if k != "fused_attention"}
    print(f"launches per training forward {per_forward}; eval forward K5 "
          f"{fused['launches']['fused_attention'] / 2:.0f}", flush=True)

    cfg = fused["config"]
    fresh = Trainer(cfg, init_random(SAMRoad.from_config(cfg), seed + 1), fused["trainer"].
                    output_dir, CLI_STEPS, device=dev)
    if fresh.restore(fused["ckpt"]) != 1 or fresh.step != CLI_STEPS:
        raise SystemExit("the restored trainer does not continue at epoch 1")
    saved = fused["trainer"].model.state_dict()
    same = all(torch.equal(v, saved[k]) for k, v in fresh.model.state_dict().items())
    if not same or applied_updates(fresh.optimizer) != CLI_STEPS:
        raise SystemExit("the checkpoint did not restore the trained state")
    print(f"checkpoint {os.path.basename(fused['ckpt'])} restored into a fresh Trainer: "
          f"weights equal, Adam count {applied_updates(fresh.optimizer)}", flush=True)
    launches, fused_peak = fused["launches"], fused["peak"]
    times = {"on": (fused["step_s"], fused["wait_s"],
                    clean_step_seconds(fused["trainer"], seed))}
    del fresh, saved, fused, cfg

    eager = run_cli(data_root, work, "eager", {"FUSED_ENCODER_TRAIN": False}, CLI_STEPS, dev)
    if eager["launches"] != {"fused_attention": 12 * CLI_STEPS + 24}:
        raise SystemExit(f"eager training launches {eager['launches']}")
    eager_peak, loader_cfg = eager["peak"], eager["config"]
    times["off"] = (eager["step_s"], eager["wait_s"],
                    clean_step_seconds(eager["trainer"], seed))
    del eager
    print("seconds per step after the first, through the CLI's loader (its wait) and "
          "without a loader: " + " | ".join(
              f"FUSED_ENCODER_TRAIN {k} {s:.4f} ({w:.4f}) {c:.4f}"
              for k, (s, w, c) in times.items()), flush=True)

    peaks = {}
    for name, fused_on in (("fused_remat", True), ("eager_remat", False)):
        run = run_cli(data_root, work, name, {"FUSED_ENCODER_TRAIN": fused_on,
                                              "REMAT_ENCODER": True}, REMAT_STEPS, dev)
        key = "ln_dense" if fused_on else "fused_attention"
        base = 12 * REMAT_STEPS + (0 if fused_on else 24)  # launches without recompute
        if run["launches"].get(key, 0) <= base:
            raise SystemExit(f"{name}: no block was recomputed: {run['launches']}")
        peaks[name] = run["peak"]
        del run
    print(f"peak memory allocated, GiB: FUSED_ENCODER_TRAIN remat off "
          f"{fused_peak / 2 ** 30:.3f} on {peaks['fused_remat'] / 2 ** 30:.3f} | eager "
          f"remat off {eager_peak / 2 ** 30:.3f} on {peaks['eager_remat'] / 2 ** 30:.3f}",
          flush=True)
    if not (peaks["fused_remat"] < fused_peak and peaks["eager_remat"] < eager_peak):
        raise SystemExit("REMAT_ENCODER did not lower peak memory")

    time_loader(loader_cfg, data_root, 4, 2)
    time_loader(loader_cfg, data_root, 1, 2)
    return launches


def check_grid_kernels(B: int, dev: str = "cuda"):
    """Phase 10a: K7, K8 and K10 at the bench shapes (B images of a 32x32
    grid padded to 42x42, C 768, 12 heads, window 14): K7 bit-equal to K1
    followed by F.pad (exact zeros in the pads), K8 bit-equal to K4 on the
    cropped attention output, K10 (group_batch 4, rolled_rows) bit-equal to
    K2, each also within TOL of its plain version in fp32; times beside the
    default path's way to the same tensor (K1 + F.pad, crop + K4, K2)."""
    import torch
    import torch.nn.functional as F

    from sam_road_tpu_torch.ops import fused_block, fused_ln

    gen = torch.Generator(device=dev).manual_seed(10)
    bf = torch.bfloat16

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    C, heads, grid, win, gp = 768, 12, 32, 14, 42
    pad = gp - grid
    nw = gp // win
    x = rn(B, grid, grid, C)
    ln = (x, 1 + rn(C, scale=0.1), rn(C, scale=0.1), rn(3 * C, C, scale=C ** -0.5))
    tail_w = (rn(C, C, scale=C ** -0.5), rn(C, scale=0.1), 1 + rn(C, scale=0.1), rn(C, scale=0.1),
              rn(4 * C, C, scale=C ** -0.5), rn(4 * C, scale=0.1),
              rn(C, 4 * C, scale=(4 * C) ** -0.5), rn(C, scale=0.1))
    a_pad = rn(B, gp, gp, C)  # pads not zero: K8 must read only the real tokens
    qkv_grid = torch.zeros((B, gp, gp, 3 * C), dtype=bf, device=dev)
    qkv_grid[:, :grid, :grid] = rn(B, grid, grid, 3 * C)
    rows = (B, nw, nw, heads, win * win, win)
    win_args = (qkv_grid, rn(3 * C, scale=0.5), rn(*rows), rn(*rows))

    def k1_pad():
        flat = fused_ln.ln_dense(x.reshape(-1, C), *ln[1:]).reshape(B, grid, grid, 3 * C)
        return F.pad(flat, (0, 0, 0, pad, 0, pad))

    def crop_k4():
        a = a_pad[:, :grid, :grid].reshape(-1, C).contiguous()
        return fused_ln.proj_ln_mlp_residual(x.reshape(-1, C), a, *tail_w).reshape(x.shape)

    def k2():
        return fused_block.window_attention_rows_grid(*win_args, win, heads)

    cases = {
        "ln_dense_padded": (lambda *t: fused_ln.ln_dense_padded(*t, (pad, pad)),
                            lambda *t: fused_ln.ln_dense_padded_plain(*t, (pad, pad)), ln, k1_pad),
        "proj_ln_mlp_residual_grid": (fused_ln.proj_ln_mlp_residual_grid,
                                      fused_ln.proj_ln_mlp_residual_grid_plain,
                                      (x, a_pad) + tail_w, crop_k4),
        "window_attention_rows_grid_rolled": (
            lambda *t: fused_block.window_attention_rows_grid(*t, win, heads, rolled_rows=True),
            lambda *t: fused_block.window_attention_rows_grid_plain(*t, win, heads),
            win_args, k2),
        "window_attention_rows_grid_gbatch": (
            lambda *t: fused_block.window_attention_rows_grid(*t, win, heads, group_batch=4),
            lambda *t: fused_block.window_attention_rows_grid_plain(*t, win, heads),
            win_args, k2),
    }
    results = {}
    for name, (kern, plain, args, default_way) in cases.items():
        got = kern(*args)
        want = default_way()
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        ref = plain(*[t.float() for t in args])
        err = (got.float() - ref).abs()
        max_abs, max_rel = err.max().item(), (err / (1 + ref.abs())).max().item()
        del ref, err, want
        row = timing_row(name, args, got, lambda: kern(*args), lambda: plain(*args))
        device = fmt_device(with_device_time(row, lambda: kern(*args), dev))
        default_ms = cuda_ms(default_way)
        ok = same and max_rel <= TOL and bool(torch.isfinite(got.float()).all())
        print(f"kernel {name}: shape {tuple(got.shape)} bit-equal to the default path "
              f"{same} max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} (tol {TOL}) "
              f"{fmt_times(row)} {device} default_path_ms {default_ms:.4f} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"kernel {name} disagrees with the default path or its plain version")
        results[name] = dict(max_abs_err=max_abs, default_path_ms=default_ms, **row)
        del got
    return results


def check_encoder_modes(dev: str = "cuda", rounds: int = 3):
    """Phase 10b: sam_road_tpu_torch/tools/experiment_fused_encoder.py at
    the bench geometry (32 patches, bf16), over its variants and PAD_FREE
    with WIN_GROUP_BATCH 4: the eager encoder and the fused one in each
    mode, timed in turns (its JSON line), every mode bit-equal to the
    default switches (v3)."""
    from sam_road_tpu_torch.tools import experiment_fused_encoder as tool

    variants = {**tool.VARIANTS, "v3padfree_g4": {"PAD_FREE": True, "WIN_GROUP_BATCH": 4}}
    res = tool.main(variants, dev, rounds=rounds, seed=SEED)
    same = {lb: res[lb + "_bit_equal_to_v3"] for lb in variants}
    print("fused encoder forward, 32 patches, bf16, least ms of the rounds: "
          + " | ".join(f"{lb} {res[lb + '_ms']:.3f}"
                       + (f" bit-equal {same[lb]}" if lb in same else "")
                       for lb in ("eager", *variants)), flush=True)
    if not all(same.values()):
        raise SystemExit(f"an encoder mode is not bit-equal to the default: {same}")
    return res


def write_sam_checkpoint(path: str, seed: int, sam_decoder: bool = False,
                         sam_version: str = "vit_b"):
    """A SAM-format .pth (image_encoder.* keys, fp32) from seeded weights at
    1024 px geometry: the 64x64 pos embed and 127-row global rel-pos tables
    that load_and_convert resizes for 512 px. With `sam_decoder` it also
    carries SAM's mask_decoder.* and prompt_encoder.* keys, the prompt
    encoder's point and mask-input layers among them (the null prompt reads
    none of those: they must be skipped)."""
    import torch

    from sam_road_tpu_torch.config import load_config
    from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random

    over = {**BENCH, "PATCH_SIZE": 1024, "USE_SAM_DECODER": sam_decoder,
            "SAM_VERSION": sam_version}
    model = init_random(SAMRoad.from_config(load_config(overrides=over)), seed)
    state = {f"image_encoder.{k}": v for k, v in model.image_encoder.state_dict().items()}
    if sam_decoder:
        state.update((k, v) for k, v in model.state_dict().items()
                     if k.startswith(("prompt_encoder.", "mask_decoder.")))
        gen = torch.Generator().manual_seed(seed)
        extra = {f"point_embeddings.{i}.weight": (1, 256) for i in range(4)}
        extra.update({"not_a_point_embed.weight": (1, 256),
                      "mask_downscaling.0.weight": (4, 1, 2, 2), "mask_downscaling.0.bias": (4,),
                      "mask_downscaling.1.weight": (4,), "mask_downscaling.1.bias": (4,),
                      "mask_downscaling.3.weight": (16, 4, 2, 2), "mask_downscaling.3.bias": (16,),
                      "mask_downscaling.4.weight": (16,), "mask_downscaling.4.bias": (16,),
                      "mask_downscaling.6.weight": (256, 16, 1, 1),
                      "mask_downscaling.6.bias": (256,)})
        state.update((f"prompt_encoder.{k}", torch.randn(shape, generator=gen))
                     for k, shape in extra.items())
    torch.save(state, path)


def run_infer_cli(seed: int, work: str, dev: str = "cuda"):
    """Phase 10c: `python -m sam_road_tpu_torch.cli.infer`, in process, over
    INFER_TILES generated 2048 px Cityscale-format test tiles, from a
    SAM-format checkpoint at 1024 px geometry (the pos-embed resize at full
    width), ViT-B 512 px, batch 32, bf16, thresholds calibrated by quantile
    as run_engine does, once in each INFER_MODES entry: the exact launches
    per batch of each run, and masks
    and graph pickles byte-equal across the runs. Returns the launches of
    each run."""
    import torch

    from sam_road_tpu_torch.cli import infer
    from sam_road_tpu_torch.config import load_config, read_flat_yaml, write_flat_yaml
    from sam_road_tpu_torch.data.dataset import read_rgb_img
    from sam_road_tpu_torch.data.partitions import cityscale_data_partition, get_patch_info_one_img
    from sam_road_tpu_torch.data.png import write_png
    from sam_road_tpu_torch.inference.engine import TiledInferenceEngine
    from sam_road_tpu_torch.models.convert import load_weights
    from sam_road_tpu_torch.ops import _build
    from sam_road_tpu_torch.tools.experiment_fused_encoder import encoder_switches

    t = time.time()
    data = os.path.join(work, "infer_data")
    sat = os.path.join(data, "cityscale", "20cities")
    os.makedirs(sat, exist_ok=True)
    _, _, test_ids = cityscale_data_partition()
    test_ids = test_ids[:INFER_TILES]
    rng = np.random.default_rng(0)
    for tile in test_ids:
        write_png(os.path.join(sat, f"region_{tile}_sat.png"),
                  rng.integers(0, 255, size=(REGION, REGION, 3), dtype=np.uint8))
    pth = os.path.join(work, "sam_vit_b_seeded.pth")
    write_sam_checkpoint(pth, seed)
    values = read_flat_yaml(FLAGSHIP)
    values.update(BENCH)
    cfg = load_config(overrides=values)
    print(f"wrote {INFER_TILES} tiles and a SAM-format checkpoint in {time.time() - t:.1f} s",
          flush=True)

    # thresholds by quantile of a first region's masks (the bench tool's calibrate)
    model, mismatched = load_weights(pth, cfg)
    engine = TiledInferenceEngine(cfg, model, dev)
    values.update(calibrate(engine, read_rgb_img(
        os.path.join(sat, f"region_{test_ids[0]}_sat.png"))))
    cfg_path = os.path.join(work, "infer.yaml")
    write_flat_yaml(cfg_path, values)
    print(f"calibrated ITSC_THRESHOLD {values['ITSC_THRESHOLD']} ROAD_THRESHOLD "
          f"{values['ROAD_THRESHOLD']}; {len(mismatched)} params not in the checkpoint "
          f"(the decoders)", flush=True)
    del model, engine
    gc.collect()  # its blocks stay in torch's cache for the CLI runs

    p, m = BENCH["PATCH_SIZE"], BENCH["SAMPLE_MARGIN"]
    n_patches = len(get_patch_info_one_img(0, REGION, m, p, BENCH["INFER_PATCHES_PER_EDGE"]))
    batches = INFER_TILES * -(-n_patches // BENCH["INFER_BATCH_SIZE"])
    runs, first = {}, None
    cwd = os.getcwd()
    os.chdir(work)  # the CLI writes ./save/<output_dir>
    try:
        for name, (switches, per_batch) in INFER_MODES.items():
            _build.reset_launches()
            t = time.time()
            with encoder_switches(switches):
                out = infer.main(["--config", cfg_path, "--checkpoint", pth, "--data_root",
                                  data, "--output_dir", name, "--max_tiles", str(INFER_TILES),
                                  "--device", dev])
                if dev == "cuda":
                    torch.cuda.synchronize()
            wall = time.time() - t
            launches = dict(_build.launches)
            files = {}
            for tile in test_ids:
                for rel in (f"mask/{tile}_road.png", f"mask/{tile}_itsc.png", f"graph/{tile}.p"):
                    with open(os.path.join(out, rel), "rb") as f:
                        files[rel] = f.read()
                if not os.path.getsize(os.path.join(out, "viz", f"{tile}.png")):
                    raise SystemExit(f"cli.infer {name}: empty viz for tile {tile}")
            with open(os.path.join(out, "inference_time.txt")) as f:
                loop_s = float(f.read().split(" in ")[-1].split(" seconds")[0])
            graphs = [pickle.loads(files[f"graph/{tile}.p"]) for tile in test_ids]
            n_nodes = [len(g) for g in graphs]
            n_edges = [sum(len(v) for v in g.values()) // 2 for g in graphs]
            want = {k: n * batches for k, n in per_batch.items()}
            print(f"cli.infer {name}: {INFER_TILES} regions in {loop_s:.3f} s "
                  f"({loop_s / INFER_TILES:.3f} s per region, the CLI's inference_time.txt; "
                  f"per-tile phase split on its 'Done for' lines), run with loading {wall:.1f} s; "
                  f"nodes {n_nodes} edges {n_edges}; launches {launches}", flush=True)
            if launches != want:
                raise SystemExit(f"cli.infer {name}: launches {launches}, expected {want}")
            if not all(n_nodes) or not all(n_edges):
                raise SystemExit(f"cli.infer {name}: an empty graph")
            if first is None:
                first = files
            elif files != first:
                raise SystemExit(f"cli.infer {name}: masks or graphs differ from the default run")
            runs[name] = dict(launches=launches, seconds_per_region=loop_s / INFER_TILES)
    finally:
        os.chdir(cwd)
    print(f"cli.infer: masks and graph pickles byte-equal across {list(runs)}", flush=True)
    return runs


def run_test_cli(work: str, dev: str = "cuda"):
    """Phase 10d: `python -m sam_road_tpu_torch.cli.test --dev_run`, in
    process, over phase 9's generated dataset with its FUSED_ENCODER_TRAIN
    run's checkpoint (the port's own ckpt_epoch_0.pt); prints the
    thresholds."""
    from sam_road_tpu_torch.cli import test
    from sam_road_tpu_torch.ops import _build

    out_json = os.path.join(work, "thresholds.json")
    _build.reset_launches()
    t = time.time()
    results = test.main(["--config", os.path.join(work, "fused.yaml"), "--checkpoint",
                         os.path.join(work, "fused", "ckpt_epoch_0.pt"), "--dev_run",
                         "--data_root", os.path.join(work, "data"), "--output_json", out_json,
                         "--device", dev])
    print(f"cli.test: {time.time() - t:.1f} s, launches {dict(_build.launches)}, thresholds "
          + ", ".join(f"{k} {v['threshold']}" for k, v in results.items()), flush=True)
    if set(results) != {"keypoint", "road", "topo"} or not os.path.exists(out_json) or not all(
            np.isfinite(v["threshold"]) for v in results.values()):
        raise SystemExit(f"cli.test: thresholds missing or not finite: {results}")
    return results


def drop_central_edges(adj: dict, n: int, size: int = REGION) -> dict:
    """`adj` without its n undirected edges whose midpoints lie nearest the
    centre of a size px region."""
    edges = sorted({tuple(sorted((a, b))) for a, v in adj.items() for b in v},
                   key=lambda e: (abs(e[0][0] + e[1][0] - size) + abs(e[0][1] + e[1][1] - size), e))
    drop = set(edges[:n])
    return {a: [b for b in v if tuple(sorted((a, b))) not in drop] for a, v in adj.items()}


def evaluate_cli(run_dirs, data: str, tiles, *flags) -> str:
    """One `python -m sam_road_tpu_torch.cli.evaluate` subprocess (the
    runner starts worker processes, which must not come from a process
    holding a CUDA context); returns its standard output."""
    cmd = [sys.executable, "-m", "sam_road_tpu_torch.cli.evaluate", "--run_dir", *run_dirs,
           "--data_root", data, "--tiles", ",".join(str(t) for t in tiles), *flags]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise SystemExit(f"cli.evaluate exit {proc.returncode}:\n{proc.stdout[-4000:]}\n"
                         f"{proc.stderr[-4000:]}")
    return proc.stdout


def tile_seconds(out: str) -> dict:
    """The runner's per-tile seconds in a cli.evaluate output: (run dir,
    "APLS" or "TOPO") -> {tile: s}."""
    seconds, run = {}, None
    for line in out.splitlines():
        if line.startswith("==== evaluating "):
            run = line.split()[2]
        elif line.startswith(("APLS ", "TOPO ")) and line.endswith(" s)"):
            metric, tile = line.split(":")[0].split()
            seconds.setdefault((run, metric), {})[tile] = float(line.rsplit("(", 1)[1].split()[0])
    return seconds


def read_scores(run: str, tiles) -> dict:
    """score/{apls,topo}.json of a run dir that held every tile's graph:
    tile -> dict(apls, p, r, f1)."""
    with open(os.path.join(run, "score", "apls.json")) as f:
        apls = json.load(f)["apls"]
    with open(os.path.join(run, "score", "topo.json")) as f:
        topo = json.load(f)
    return {t: dict(apls=a, p=p, r=r, f1=f1) for t, a, p, r, f1 in
            zip(tiles, apls, topo["prec"], topo["recall"], topo["f1"], strict=True)}


def run_evaluate_cli(work: str) -> dict:
    """Phase 16: the evaluation CLI (`python -m sam_road_tpu_torch.cli.evaluate`,
    native APLS and TOPO) over phase 10's cli.infer graphs (save/default) on
    the coarse grid's tile (native APLS takes about 50 s on the random
    weights' graph over the arterial grid, the same path) and two run dirs
    of its own on both tiles, against a street-grid ground truth written for
    each tile (EVAL_GRIDS):
    - truth: the ground truth as the graph scores APLS > EVAL_APLS_MIN and
      TOPO P, R and F1 > EVAL_TOPO_MIN on every tile;
    - degraded: the ground truth less EVAL_DROPS central edges scores lower
      on APLS and on TOPO F1, on every tile;
    - on the coarse grid's degraded graph, the CLI's --no_native APLS is
      within 1e-6 of the native (which prints 6 decimals), and the Python
      TOPO (metrics._native.USE_NATIVE off, in process) equals the CLI's
      native TOPO exactly.
    The random-weight graphs score low: their scores are printed, checked
    only to lie in [0, 1]. Returns the seconds per tile of each scorer."""
    from sam_road_tpu_torch.data.partitions import cityscale_data_partition
    from sam_road_tpu_torch.metrics import _native, topo

    t0 = time.time()
    tiles = cityscale_data_partition()[2][:INFER_TILES]
    data = os.path.join(work, "infer_data")
    gt = {}
    for tile, (lo, hi, spacing) in zip(tiles, EVAL_GRIDS, strict=True):
        gt[tile] = street_grid(list(range(lo, hi + 1, spacing)))
        with open(os.path.join(data, "cityscale", "20cities",
                               f"region_{tile}_graph_gt.pickle"), "wb") as f:
            pickle.dump(gt[tile], f)
    degraded = {t: drop_central_edges(g, EVAL_DROPS) for t, g in gt.items()}
    runs = {"infer": os.path.join(work, "save", "default")}
    for name, graphs in (("truth", gt), ("degraded", degraded),
                         ("python", {tiles[-1]: degraded[tiles[-1]]})):
        runs[name] = os.path.join(work, "eval", name)
        os.makedirs(os.path.join(runs[name], "graph"))
        for tile, adj in graphs.items():
            with open(os.path.join(runs[name], "graph", f"{tile}.p"), "wb") as f:
                pickle.dump(adj, f)
    scored = {"infer": tiles[-1:], "truth": tiles, "degraded": tiles}
    t = time.time()
    per_tile = tile_seconds(evaluate_cli([runs["infer"]], data, scored["infer"]))
    per_tile.update(tile_seconds(evaluate_cli([runs["truth"], runs["degraded"]], data, tiles)))
    cli_s = time.time() - t
    seconds = {f"{name} {metric} native": per_tile.get((runs[name], metric))
               for name in scored for metric in ("APLS", "TOPO")}
    scores = {name: read_scores(runs[name], scored[name]) for name in scored}
    for name, by_tile in scores.items():
        for tile, s in by_tile.items():
            print(f"cli.evaluate {name} tile {tile}: APLS {s['apls']} TOPO P {s['p']} "
                  f"R {s['r']} F1 {s['f1']}", flush=True)
    t = time.time()
    out = evaluate_cli([runs["python"]], data, tiles[-1:], "--metric", "apls", "--no_native")
    python_cli_s = time.time() - t
    seconds["degraded APLS python"] = tile_seconds(out).get((runs["python"], "APLS"))
    with open(os.path.join(runs["python"], "score", "apls.json")) as f:
        python_apls = json.load(f)["apls"][0]
    _native.USE_NATIVE = False
    try:
        t = time.time()
        p, r, f1 = topo.topo_score_one_tile(gt[tiles[-1]], degraded[tiles[-1]])
        seconds["degraded TOPO python"] = {str(tiles[-1]): round(time.time() - t, 3)}
    finally:
        _native.USE_NATIVE = True
    native = scores["degraded"][tiles[-1]]
    bad = [f"{name} tile {tile}: {s}" for name in ("infer", "truth", "degraded")
           for tile, s in scores[name].items()
           if not all(0.0 <= v <= 1.0 for v in s.values())]
    for tile in tiles:
        truth, worse = scores["truth"][tile], scores["degraded"][tile]
        if truth["apls"] <= EVAL_APLS_MIN or min(truth["p"], truth["r"], truth["f1"]) <= EVAL_TOPO_MIN:
            bad.append(f"truth tile {tile}: {truth}")
        if not (worse["apls"] < truth["apls"] and worse["f1"] < truth["f1"]):
            bad.append(f"degraded tile {tile} {worse} not below truth {truth}")
    if abs(python_apls - native["apls"]) >= 1e-6:
        bad.append(f"--no_native APLS {python_apls} vs native {native['apls']}")
    if (p, r, f1) != (native["p"], native["r"], native["f1"]):
        bad.append(f"Python TOPO {(p, r, f1)} vs native {native}")
    print(f"cli.evaluate: tile {tiles[-1]} degraded: --no_native APLS {python_apls} vs native "
          f"{native['apls']}; Python TOPO {(p, r, f1)} vs native "
          f"{(native['p'], native['r'], native['f1'])}", flush=True)
    print(f"cli.evaluate seconds per tile (the runner's workers, two tiles at once): "
          f"{json.dumps(seconds)}; the CLI over three run dirs {cli_s:.1f} s, --no_native "
          f"{python_cli_s:.1f} s; phase {time.time() - t0:.1f} s | {gpu_line()}", flush=True)
    if any(v is None or set(v) != {str(t) for t in scored[k.split()[0]]}
           for k, v in seconds.items() if "native" in k):
        bad.append(f"a per-tile line missing from the CLI's output: {seconds}")
    if bad:
        raise SystemExit("cli.evaluate: " + "; ".join(bad))
    return seconds


def lora_values(extra: dict | None = None) -> dict:
    """LORA_CONFIG's keys as load_config overrides, with `extra` on top (a
    CPU rehearsal's smaller geometry)."""
    from sam_road_tpu_torch.config import read_flat_yaml

    values = read_flat_yaml(LORA_CONFIG)
    values.update(extra or {})
    return values


def live_lora(model, seed: int):
    """LoRA's B ~ N(0, 1/rank) from a seeded generator: init_random leaves
    it zero, as the JAX init does, and a zero B hides the adapters."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".linear_b_" in name:
                p.copy_(torch.randn(p.shape, generator=gen) * p.shape[1] ** -0.5)
    return model


def check_lora_model(model, values: dict, dev: str = "cuda", n: int = 4):
    """Phase 17a: the LoRA + SAM-decoder model as the engine runs it (the
    config's compute dtype, the eager encoder through K5) against the same
    weights in fp32 plain ops (FLASH_ATTENTION off) on n random patches:
    the embeddings' and the mask logits' cosine >= COS_MIN. The adapters
    are live: zeroing B moves the embeddings."""
    import torch
    import torch.nn.functional as F

    from sam_road_tpu_torch.config import load_config
    from sam_road_tpu_torch.models.sam_road import SAMRoad

    model.to(dev).eval()
    ref = SAMRoad.from_config(load_config(overrides={**values, "COMPUTE_DTYPE": "float32",
                                                     "FLASH_ATTENTION": False}))
    ref.load_state_dict(model.state_dict())
    ref.to(dev).eval()
    p = model.patch_size
    gen = torch.Generator(device=dev).manual_seed(3)
    rgb = torch.randint(0, 255, (n, p, p, 3), generator=gen, device=dev).float()
    adapters = {k: v for k, v in model.named_parameters() if ".linear_b_" in k}
    with torch.no_grad():
        emb = model.image_encoder(model.normalize(rgb))
        logits = model.mask_logits(emb)
        emb32 = ref.image_encoder(ref.normalize(rgb))
        logits32 = ref.mask_logits(emb32)
        saved = {k: v.clone() for k, v in adapters.items()}
        for v in adapters.values():
            v.zero_()
        emb_b0 = model.image_encoder(model.normalize(rgb))
        for k, v in adapters.items():
            v.copy_(saved[k])
    del ref

    def cos(a, b):
        return F.cosine_similarity(a.float().flatten(), b.float().flatten(), dim=0).item()

    c_emb, c_mask = cos(emb, emb32), cos(logits, logits32)
    live = (emb_b0.float() - emb.float()).abs().max().item()
    ok = (c_emb >= COS_MIN and c_mask >= COS_MIN and live > 0
          and bool(torch.isfinite(logits).all()) and logits.shape == (n, p, p, 2))
    print(f"LoRA rank {model.lora_rank} + SAM decoder ({values['COMPUTE_DTYPE']}, K5) vs fp32 "
          f"plain on {n} patches: embeddings cosine {c_emb:.6f}, mask logits {tuple(logits.shape)} "
          f"cosine {c_mask:.6f} (min {COS_MIN}); zeroing LoRA's B moves the embeddings by up to "
          f"{live:.4f} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("the LoRA + SAM-decoder model disagrees with its fp32 plain version")


def run_lora(seed: int, dev: str = "cuda", extra: dict | None = None, region: int = REGION,
             per_forward: int = 12):
    """Phase 17a-b: LORA_CONFIG as it stands (with `extra` on top) and
    seeded weights with live adapters: check_lora_model, a `region` px
    region through the engine with thresholds by quantile (K5, per_forward
    launches a forward), then run_training's steps and validation at the
    config's geometry, where the base encoder stays bit-unchanged and the
    adapters, the SAM decoder and TopoNet move. Returns the launches of
    both."""
    import torch

    from sam_road_tpu_torch.config import load_config
    from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random

    values = lora_values(extra)
    model = live_lora(init_random(SAMRoad.from_config(load_config(overrides=values)), seed),
                      seed + 1)
    check_lora_model(model, values, dev)
    out = {"region": run_engine(seed, values, region, {"fused_attention": per_forward}, dev,
                                model=model)}
    out["training"] = run_training(seed, dev, overrides=values, model=model, watch=LORA_WATCH,
                                   per_forward=per_forward)
    del model
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def run_lora_cli(seed: int, work: str, dev: str = "cuda", extra: dict | None = None,
                 per_forward: int = 12):
    """Phase 17c: the CLIs with LORA_CONFIG (and `extra`), from a SAM-format
    .pth with the decoder's keys (write_sam_checkpoint), over phase 9's
    dataset and phase 10's tiles under `work`: load_and_convert fills every
    parameter but the adapters and TopoNet, the SAM decoder's included;
    `cli.train --dev_run` trains LORA_CLI_STEPS steps (K5, the base encoder
    bit-equal to the checkpoint's after them), `cli.test --dev_run`
    calibrates on its checkpoint, and `cli.infer` runs INFER_TILES tiles
    with thresholds by quantile (exact launches, non-empty graphs).
    Returns the launches of each CLI."""
    import torch

    from sam_road_tpu_torch.cli import infer, test
    from sam_road_tpu_torch.config import load_config, write_flat_yaml
    from sam_road_tpu_torch.data.dataset import read_rgb_img
    from sam_road_tpu_torch.data.partitions import cityscale_data_partition, get_patch_info_one_img
    from sam_road_tpu_torch.inference.engine import TiledInferenceEngine
    from sam_road_tpu_torch.models.convert import load_and_convert, load_weights
    from sam_road_tpu_torch.ops import _build

    t = time.time()
    values = lora_values(extra)
    pth = os.path.join(work, "sam_decoder.pth")
    write_sam_checkpoint(pth, seed, sam_decoder=True, sam_version=values["SAM_VERSION"])
    cfg = load_config(overrides=values)
    model, matched, mismatched = load_and_convert(pth, cfg)
    names = list(model.state_dict())
    want = {n for n in names if ".linear_" in n or n.startswith("topo_net.")}
    n_dec = sum(n.startswith(("prompt_encoder.", "mask_decoder.")) for n in matched)
    print(f"load_and_convert of the SAM-format .pth: {len(matched)} matched ({n_dec} of the SAM "
          f"decoder's {sum(n.startswith(('prompt_encoder.', 'mask_decoder.')) for n in names)}), "
          f"{len(mismatched)} left at init (the adapters and TopoNet: {set(mismatched) == want}); "
          f"{time.time() - t:.1f} s", flush=True)
    if set(mismatched) != want:
        raise SystemExit(f"load_and_convert left unexpected parameters unloaded: "
                         f"{sorted(set(mismatched) ^ want)[:8]}")
    base = {n: v.clone() for n, v in model.state_dict().items()
            if n.startswith("image_encoder.") and ".linear_" not in n}
    start = {n: model.state_dict()[n].clone() for n in LORA_CLI_WATCH}
    del model

    run = run_cli(os.path.join(work, "data"), work, "lora", {**(extra or {}),
                  "FUSED_ENCODER_TRAIN": False}, LORA_CLI_STEPS, dev, base=LORA_CONFIG,
                  args=("--sam_ckpt", pth))
    launches = {"cli_train": run["launches"]}
    if run["launches"] != {"fused_attention": per_forward * (LORA_CLI_STEPS + 2)}:
        raise SystemExit(f"cli.train with LoRA: launches {run['launches']}")  # + eval, panels
    state = {n: v.cpu() for n, v in run["trainer"].model.state_dict().items()}
    same = all(torch.equal(state[n], v) for n, v in base.items())
    moved = {n: (state[n] - v).abs().max().item() for n, v in start.items()}
    print(f"cli.train with LoRA: base encoder bit-equal to the checkpoint's after "
          f"{LORA_CLI_STEPS} steps {same}; moved (max abs change) {moved}", flush=True)
    if not same or not all(v > 0 for v in moved.values()):
        raise SystemExit("cli.train with LoRA changed the frozen base encoder or left an "
                         "adapter or the decoder unchanged")
    del run, state, base
    gc.collect()

    _build.reset_launches()
    out_json = os.path.join(work, "lora_thresholds.json")
    results = test.main(["--config", os.path.join(work, "lora.yaml"), "--checkpoint",
                         os.path.join(work, "lora", "ckpt_epoch_0.pt"), "--dev_run",
                         "--data_root", os.path.join(work, "data"), "--output_json", out_json,
                         "--device", dev])
    launches["cli_test"] = dict(_build.launches)
    print(f"cli.test with LoRA: launches {launches['cli_test']}, thresholds "
          + ", ".join(f"{k} {v['threshold']}" for k, v in results.items()), flush=True)
    if set(results) != {"keypoint", "road", "topo"} or not all(
            np.isfinite(v["threshold"]) for v in results.values()):
        raise SystemExit(f"cli.test with LoRA: thresholds missing or not finite: {results}")

    sat = os.path.join(work, "infer_data", "cityscale", "20cities")
    test_ids = cityscale_data_partition()[2][:INFER_TILES]
    model, mismatched = load_weights(pth, cfg)
    if set(mismatched) != want:
        raise SystemExit("load_weights left unexpected parameters unloaded")
    engine = TiledInferenceEngine(cfg, model, dev)
    values.update(calibrate(engine, read_rgb_img(os.path.join(
        sat, f"region_{test_ids[0]}_sat.png"))))
    cfg_path = os.path.join(work, "lora_infer.yaml")
    write_flat_yaml(cfg_path, values)
    del model, engine
    gc.collect()
    size = read_rgb_img(os.path.join(sat, f"region_{test_ids[0]}_sat.png")).shape[0]
    n_patches = len(get_patch_info_one_img(0, size, int(cfg.SAMPLE_MARGIN), int(cfg.PATCH_SIZE),
                                           int(cfg.INFER_PATCHES_PER_EDGE)))
    batches = INFER_TILES * -(-n_patches // int(cfg.INFER_BATCH_SIZE))
    cwd = os.getcwd()
    os.chdir(work)  # the CLI writes ./save/<output_dir>
    try:
        _build.reset_launches()
        t = time.time()
        out = infer.main(["--config", cfg_path, "--checkpoint", pth, "--data_root",
                          os.path.join(work, "infer_data"), "--output_dir", "lora",
                          "--max_tiles", str(INFER_TILES), "--device", dev])
        if dev == "cuda":
            torch.cuda.synchronize()
        wall = time.time() - t
        launches["cli_infer"] = dict(_build.launches)
        graphs = []
        for tile in test_ids:
            with open(os.path.join(out, "graph", f"{tile}.p"), "rb") as f:
                graphs.append(pickle.load(f))
            for rel in (f"mask/{tile}_road.png", f"mask/{tile}_itsc.png", f"viz/{tile}.png"):
                if not os.path.getsize(os.path.join(out, rel)):
                    raise SystemExit(f"cli.infer with LoRA: empty {rel}")
        with open(os.path.join(out, "inference_time.txt")) as f:
            loop_s = float(f.read().split(" in ")[-1].split(" seconds")[0])
    finally:
        os.chdir(cwd)
    n_nodes = [len(g) for g in graphs]
    n_edges = [sum(len(v) for v in g.values()) // 2 for g in graphs]
    print(f"cli.infer with LoRA: thresholds ITSC {values['ITSC_THRESHOLD']} ROAD "
          f"{values['ROAD_THRESHOLD']}; {INFER_TILES} regions in {loop_s:.3f} s "
          f"({loop_s / INFER_TILES:.3f} s per region, the CLI's inference_time.txt), run with "
          f"loading {wall:.1f} s; nodes {n_nodes} edges {n_edges}; launches "
          f"{launches['cli_infer']}", flush=True)
    if launches["cli_infer"] != {"fused_attention": per_forward * batches}:
        raise SystemExit(f"cli.infer with LoRA: launches {launches['cli_infer']}, expected "
                         f"fused_attention {per_forward * batches}")
    if not all(n_nodes) or not all(n_edges):
        raise SystemExit("cli.infer with LoRA: an empty graph")
    return launches


def run_config_regions(seed: int, dev: str = "cuda"):
    """Phase 18: one REGION px region through each REGION_CONFIGS file as it
    stands (FUSED_ENCODER: K1-K4), seeded weights; returns each run's
    launches."""
    import torch

    from sam_road_tpu_torch.config import read_flat_yaml

    out = {}
    for path, per_batch in REGION_CONFIGS.items():
        values = read_flat_yaml(path)
        print(f"{path}: {values['SAM_VERSION']} at {values['PATCH_SIZE']} px, batch "
              f"{values['INFER_BATCH_SIZE']}, {values['COMPUTE_DTYPE']}, FUSED_ENCODER "
              f"{values['FUSED_ENCODER']}", flush=True)
        out[path] = run_engine(seed, values, REGION, per_batch, dev, repeats=1)
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()
    return out


def street_graph(rng, size: int, to_key, spacing=(70, 100), pieces: int = 3) -> dict:
    """A ground-truth road graph over a size px tile as a sat2graph dict
    (to_key: image (x, y) -> its (r, c) key): a street grid at a random
    spacing and offset whose block edges are split into `pieces` (degree-2
    nodes) and about 15 % dropped (degree-3 junctions, dead ends), two
    diagonal avenues across it (their points joining the grid only where
    they land on it), a dead-end spur per grid row, and a road running off
    the tile's right edge."""
    adj = {}

    def road(points):
        for a, b in zip(points[:-1], points[1:]):
            ka, kb = to_key(*a), to_key(*b)
            if ka != kb:
                adj.setdefault(ka, []).append(kb)
                adj.setdefault(kb, []).append(ka)

    def split(a, b, n=pieces):
        return [(round(a[0] + (b[0] - a[0]) * i / n), round(a[1] + (b[1] - a[1]) * i / n))
                for i in range(n + 1)]

    step = int(rng.integers(*spacing))
    lines = list(range(int(rng.integers(step // 4, step // 2)), size - step // 4, step))
    for i, y in enumerate(lines):
        for j, x in enumerate(lines):
            if j + 1 < len(lines) and rng.random() > 0.15:
                road(split((x, y), (lines[j + 1], y)))
            if i + 1 < len(lines) and rng.random() > 0.15:
                road(split((x, y), (x, lines[i + 1])))
        x = lines[int(rng.integers(0, len(lines)))]
        road(split((x, y), (x + step // 3, y + step // 5), 2))  # a dead-end spur
    first, last = lines[0], lines[-1]
    road(split((first, lines[1]), (last, lines[-2]), 4 * pieces))
    road(split((lines[1], last), (lines[-2], first), 4 * pieces))
    road(split((last, lines[1]), (size, lines[1]), 1))
    return adj


def degrees_xy(graph: dict, to_xy):
    """(x, y) node -> degree of the undirected graph, each edge once."""
    edges = {tuple(sorted((to_xy(a), to_xy(b)))) for a, v in graph.items() for b in v
             if to_xy(a) != to_xy(b)}
    deg = {}
    for a, b in edges:
        deg[a] = deg.get(a, 0) + 1
        deg[b] = deg.get(b, 0) + 1
    return deg, edges


def spacenet_xy(n):
    """A SpaceNet ground-truth key (r, c) -> image (x, y) = (c, 400 - r)."""
    return int(n[1]), 400 - int(n[0])


def cityscale_xy(n):
    """A Cityscale ground-truth key (r, c) -> image (x, y) = (c, r)."""
    return int(n[1]), int(n[0])


def write_tile(path: str, graph: dict, size: int, to_xy, rng):
    """A size px RGB tile for `graph`: noise in [70, 190) with the roads
    drawn a third as bright (every value in [23, 190))."""
    from sam_road_tpu_torch.data.png import write_png
    from sam_road_tpu_torch.utils.viz import draw_lines

    rgb = rng.integers(70, 190, (size, size, 3), dtype=np.uint8)
    road = np.zeros((size, size), np.uint8)
    _, edges = degrees_xy(graph, to_xy)
    ends = np.array(sorted(edges), np.int64).reshape(-1, 2, 2)
    draw_lines(road, ends[:, 0], ends[:, 1], 1, 7)
    rgb[road > 0] //= 3
    write_png(path, rgb)


def write_spacenet_tree(root: str, seed: int) -> dict:
    """A SpaceNet-format dataset under root/spacenet: SPACENET_SPLIT tiles of
    400 px named SYN_<i>, data_split.json, RGB_1.0_meter/<tile>__rgb.png and
    __gt_graph.p (keys (r, c) with image (x, y) = (c, 400 - r)); no
    processed/. Returns tile -> graph."""
    base = os.path.join(root, "spacenet")
    sat = os.path.join(base, "RGB_1.0_meter")
    os.makedirs(sat, exist_ok=True)
    names = iter(f"SYN_{i}" for i in range(sum(SPACENET_SPLIT.values())))
    split = {k: [next(names) for _ in range(n)] for k, n in SPACENET_SPLIT.items()}
    with open(os.path.join(base, "data_split.json"), "w") as f:
        json.dump(split, f)
    rng = np.random.default_rng(seed)
    graphs = {}
    for tile in sum(split.values(), []):
        graphs[tile] = street_graph(rng, 400, lambda x, y: (400 - y, x))
        with open(os.path.join(sat, f"{tile}__gt_graph.p"), "wb") as f:
            pickle.dump(graphs[tile], f)
        write_tile(os.path.join(sat, f"{tile}__rgb.png"), graphs[tile], 400, spacenet_xy, rng)
    return graphs


def write_cityscale_tree(root: str, seed: int, tiles) -> dict:
    """Cityscale-format ground truth under root/cityscale/20cities for the
    partition indices `tiles`: region_<i>_refine_gt_graph.p over the full
    2048 px (keys (r, c) = (y, x)) and region_<i>_sat.png; no processed/.
    Returns tile -> graph."""
    sat = os.path.join(root, "cityscale", "20cities")
    os.makedirs(sat, exist_ok=True)
    rng = np.random.default_rng(seed)
    graphs = {}
    for tile in tiles:
        graphs[tile] = street_graph(rng, 2048, lambda x, y: (y, x), spacing=(250, 330), pieces=5)
        with open(os.path.join(sat, f"region_{tile}_refine_gt_graph.p"), "wb") as f:
            pickle.dump(graphs[tile], f)
        write_tile(os.path.join(sat, f"region_{tile}_sat.png"), graphs[tile], 2048,
                   cityscale_xy, rng)
    return graphs


def check_masks(processed: str, graphs: dict, size: int, to_xy) -> dict:
    """cli.prepare's masks against their graphs: both PNGs of every tile,
    grayscale size x size; a keypoint pixel at every node inside the tile
    whose degree is not 2 and none at a degree-2 node farther than the
    disc's radius + 1 from every other kind of node; a road pixel at every
    edge's midpoint inside the tile. Returns counts of what was checked."""
    from sam_road_tpu_torch.data.label_gen import KEYPOINT_RADIUS
    from sam_road_tpu_torch.data.png import read_png

    counts = dict(tiles=0, keypoints=0, degree2_clear=0, midpoints=0)
    for tile, graph in graphs.items():
        kp = read_png(os.path.join(processed, f"keypoint_mask_{tile}.png"))
        road = read_png(os.path.join(processed, f"road_mask_{tile}.png"))
        if kp.shape != (size, size) or road.shape != (size, size):
            raise SystemExit(f"tile {tile}: masks {kp.shape} {road.shape}, expected {size} px")
        deg, edges = degrees_xy(graph, to_xy)
        inside = {p: d for p, d in deg.items() if 0 <= p[0] < size and 0 <= p[1] < size}
        junctions = np.array([p for p, d in deg.items() if d != 2], np.int64).reshape(-1, 2)
        for (x, y), d in inside.items():
            if d != 2:
                if kp[y, x] != 255:
                    raise SystemExit(f"tile {tile}: no keypoint at degree-{d} node {(x, y)}")
                counts["keypoints"] += 1
            elif np.abs(junctions - (x, y)).max(1).min() > KEYPOINT_RADIUS + 1:
                if kp[y, x] != 0:
                    raise SystemExit(f"tile {tile}: a keypoint at degree-2 node {(x, y)}")
                counts["degree2_clear"] += 1
        for (x0, y0), (x1, y1) in edges:
            xm, ym = (x0 + x1) // 2, (y0 + y1) // 2
            if 0 <= xm < size and 0 <= ym < size:
                if road[ym, xm] != 255:
                    raise SystemExit(f"tile {tile}: no road at the midpoint of {(x0, y0)}-{(x1, y1)}")
                counts["midpoints"] += 1
        counts["tiles"] += 1
    return counts


def run_prepare(root: str, dataset: str, graphs: dict, size: int, to_xy) -> float:
    """`python -m sam_road_tpu_torch.cli.prepare`, in process, then
    check_masks; returns its host seconds per tile."""
    from sam_road_tpu_torch.cli import prepare

    t = time.perf_counter()
    tiles = prepare.main(["--dataset", dataset, "--data_root", root])
    seconds = time.perf_counter() - t
    processed = os.path.join(root, dataset, "processed")
    if sorted(map(str, tiles)) != sorted(map(str, graphs)) or sorted(
            os.listdir(processed)) != sorted(f"{kind}_mask_{t}.png" for t in graphs
                                             for kind in ("keypoint", "road")):
        raise SystemExit(f"cli.prepare {dataset}: wrote {sorted(os.listdir(processed))}")
    counts = check_masks(processed, graphs, size, to_xy)
    print(f"cli.prepare {dataset}: {len(tiles)} tiles of {size} px in {seconds:.3f} s "
          f"({seconds / len(tiles):.4f} s per tile, host clock); checked {counts}", flush=True)
    return seconds / len(tiles)


def run_debug_labels(root: str, work: str, num: int = 16):
    """`python -m sam_road_tpu_torch.cli.debug_labels` with SPACENET_CONFIG
    over the SpaceNet tree: `num` PNGs, each readable by read_png and
    holding drawn pixels (a channel outside the tiles' [23, 190))."""
    from sam_road_tpu_torch.cli import debug_labels
    from sam_road_tpu_torch.data.png import read_png

    out = os.path.join(work, "debug_labels")
    t = time.perf_counter()
    paths = debug_labels.main(["--config", SPACENET_CONFIG, "--data_root", root, "--out", out,
                               "--num", str(num)])
    seconds = time.perf_counter() - t
    drawn = []
    for path in paths:
        img = read_png(path)
        drawn.append(int(((img < 23) | (img >= 190)).any(-1).sum()))
    print(f"cli.debug_labels: {len(paths)} PNGs in {seconds:.2f} s, drawn pixels each "
          f"{drawn}", flush=True)
    if sorted(os.listdir(out)) != sorted(f"viz_{i}.png" for i in range(num)) or not all(drawn):
        raise SystemExit(f"cli.debug_labels: missing or empty images: {sorted(os.listdir(out))}")


def spacenet_values(extra: dict | None = None) -> dict:
    """SPACENET_CONFIG as it stands, one epoch (`extra` on top)."""
    from sam_road_tpu_torch.config import read_flat_yaml

    values = read_flat_yaml(SPACENET_CONFIG)
    values.update(TRAIN_EPOCHS=1)
    values.update(extra or {})
    return values


def run_spacenet_train(root: str, work: str, dev: str = "cuda", extra: dict | None = None):
    """Phase 19c: `python -m sam_road_tpu_torch.cli.train --dev_run`, in
    process, with SPACENET_CONFIG over the prepared SpaceNet tree,
    SPACENET_STEPS steps from init_random seed 0: every loss finite, no step
    skipped, the checkpoint written, K5 launched SPACENET_PER_FORWARD times
    a forward (each step's and the two validation forwards); then the step
    without a loader (clean_step_seconds). Returns the launches, the
    checkpoint and the times."""
    import torch

    from sam_road_tpu_torch.cli import train
    from sam_road_tpu_torch.config import write_flat_yaml
    from sam_road_tpu_torch.ops import _build

    cfg = os.path.join(work, "spacenet.yaml")
    write_flat_yaml(cfg, spacenet_values(extra))
    out = os.path.join(work, "spacenet_train")
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t = time.time()
    trainer = train.main(["--config", cfg, "--dev_run", "--steps_per_epoch", str(SPACENET_STEPS),
                          "--device", dev, "--data_root", root, "--output_dir", out])
    if dev == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    hist = list(trainer.history)
    step_s = statistics.mean(h["seconds"] for h in hist[1:])
    wait_s = statistics.mean(h["data_seconds"] for h in hist[1:])
    cfg_run = trainer.config
    clean_s = clean_step_seconds(trainer, 0, dict(
        PATCH_SIZE=int(cfg_run.PATCH_SIZE), BATCH_SIZE=int(cfg_run.BATCH_SIZE),
        TOPO_SAMPLE_NUM=int(cfg_run.TOPO_SAMPLE_NUM),
        MAX_NEIGHBOR_QUERIES=int(cfg_run.MAX_NEIGHBOR_QUERIES)))
    ckpt = os.path.join(out, "ckpt_epoch_0.pt")
    print(f"cli.train spacenet: {len(hist)} steps at batch {cfg_run.BATCH_SIZE}, "
          f"{cfg_run.PATCH_SIZE} px; seconds per step (host clock, Trainer.train_epoch): "
          f"{', '.join(f'{h['seconds']:.4f}' for h in hist)}; after the first, through the "
          f"CLI's loader: mean {step_s:.4f} s, loader wait {wait_s:.4f} s; without a loader "
          f"{clean_s:.4f} s; peak memory "          f"allocated {peak / 2 ** 30:.3f} GiB; losses "
          f"{', '.join(f'{h['loss']:.4f}' for h in hist)}; run {wall:.1f} s; launches "
          f"{launches}", flush=True)
    if len(hist) != SPACENET_STEPS or not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                                              for h in hist):
        raise SystemExit("cli.train spacenet: a loss or grad_norm is not finite, or steps missing")
    if any(h["skipped"] for h in hist):
        raise SystemExit("cli.train spacenet: a training step was skipped")
    if not os.path.exists(ckpt):
        raise SystemExit("cli.train spacenet: no checkpoint")
    want = {k: n * (SPACENET_STEPS + 2) for k, n in SPACENET_PER_FORWARD.items()}
    if launches != want:
        raise SystemExit(f"cli.train spacenet: launches {launches}, expected {want}")
    return dict(launches=launches, ckpt=ckpt, cfg=cfg, step_s=step_s, wait_s=wait_s,
                clean_s=clean_s, peak=peak)


def sat2graph_rc(graph: dict, size: int = 400):
    """A SpaceNet-frame sat2graph dict -> (normalised image (r, c) nodes,
    edges [E, 2]): the frame's (r', c') is the image's (size - r', c)."""
    from sam_road_tpu_torch.graph.convert import convert_from_sat2graph_format

    nodes, edges = convert_from_sat2graph_format(graph)
    rc = np.stack([size - nodes[:, 0], nodes[:, 1]], 1).astype(np.float64) / size
    return rc, np.asarray(edges, np.int64).reshape(-1, 2)


def run_spacenet_infer(root: str, work: str, trained: dict, dev: str = "cuda"):
    """Phase 19d: `python -m sam_road_tpu_torch.cli.infer`, in process, of
    19c's checkpoint over the SpaceNet test tiles (SPACENET_CONFIG's
    FUSED_ENCODER: K1-K4), thresholds calibrated by quantile on the first
    tile as run_infer_cli does (TOPO_THRESHOLD too: after a few steps
    TopoNet scores no pair above the config's), with the exact launches per
    batch and an edge in every tile's graph; then
    `python -m sam_road_tpu_torch.cli.triage` over an inference_results
    pickle of its graphs against the ground truth. Returns the launches."""
    import random

    import torch
    from scipy.spatial import cKDTree

    from sam_road_tpu_torch.cli import infer, triage
    from sam_road_tpu_torch.config import load_config, read_flat_yaml, write_flat_yaml
    from sam_road_tpu_torch.data.dataset import read_rgb_img
    from sam_road_tpu_torch.data.partitions import get_patch_info_one_img
    from sam_road_tpu_torch.data.png import read_png
    from sam_road_tpu_torch.inference.engine import TiledInferenceEngine, _unpack_bits
    from sam_road_tpu_torch.models.convert import load_weights
    from sam_road_tpu_torch.ops import _build

    values = read_flat_yaml(trained["cfg"])
    cfg = load_config(overrides=values)
    sat = os.path.join(root, "spacenet", "RGB_1.0_meter")
    with open(os.path.join(root, "spacenet", "data_split.json")) as f:
        test_ids = json.load(f)["test"]
    model, _ = load_weights(trained["ckpt"], cfg)
    engine = TiledInferenceEngine(cfg, model, dev)
    values.update(calibrate(engine, read_rgb_img(os.path.join(sat, f"{test_ids[0]}__rgb.png"))))
    # TOPO_THRESHOLD: the median of the same tile's pair scores, less half
    # a step of their int16 fixed point, so a pair scoring it on every
    # observation is kept
    scores, scores_q = [], engine._scores_q

    def record(feats, points, tgt, valid_packed):
        q = scores_q(feats, points, tgt, valid_packed)
        valid = _unpack_bits(valid_packed, tgt.shape[-1])
        scores.append(q[..., 0][valid].float().cpu().numpy() / 32767.0)
        return q

    engine._scores_q = record
    engine.infer_one_img(read_rgb_img(os.path.join(sat, f"{test_ids[0]}__rgb.png")))
    values["TOPO_THRESHOLD"] = float(np.quantile(np.concatenate(scores), 0.5)) - 0.5 / 32767.0
    cfg_path = os.path.join(work, "spacenet_infer.yaml")
    write_flat_yaml(cfg_path, values)
    del model, engine
    gc.collect()
    p, m = cfg.PATCH_SIZE, cfg.SAMPLE_MARGIN
    n_patches = len(get_patch_info_one_img(0, 400, m, p, cfg.INFER_PATCHES_PER_EDGE))
    batches = len(test_ids) * -(-n_patches // cfg.INFER_BATCH_SIZE)
    cwd = os.getcwd()
    os.chdir(work)  # the CLI writes ./save/<output_dir>
    try:
        _build.reset_launches()
        t = time.time()
        out = infer.main(["--config", cfg_path, "--checkpoint", trained["ckpt"], "--data_root",
                          root, "--output_dir", "spacenet", "--device", dev])
        if dev == "cuda":
            torch.cuda.synchronize()
        wall = time.time() - t
        launches = dict(_build.launches)
        out = os.path.join(work, out)
    finally:
        os.chdir(cwd)
    with open(os.path.join(out, "inference_time.txt")) as f:
        loop_s = float(f.read().split(" in ")[-1].split(" seconds")[0])
    want = {k: n * batches for k, n in SPACENET_INFER_PER_BATCH.items()}
    graphs = {}
    for tile in test_ids:
        with open(os.path.join(out, "graph", f"{tile}.p"), "rb") as f:
            graphs[tile] = pickle.load(f)
    n_nodes = [len(g) for g in graphs.values()]
    n_edges = [sum(len(v) for v in g.values()) // 2 for g in graphs.values()]
    print(f"cli.infer spacenet: {len(test_ids)} tiles in {loop_s:.3f} s ({loop_s / len(test_ids):.3f} "
          f"s per tile, the CLI's inference_time.txt), run with loading {wall:.1f} s; "
          f"{batches} batches of {cfg.INFER_BATCH_SIZE}; ITSC_THRESHOLD "
          f"{values['ITSC_THRESHOLD']:.4f} ROAD_THRESHOLD {values['ROAD_THRESHOLD']:.4f} "
          f"TOPO_THRESHOLD {values['TOPO_THRESHOLD']:.5f} (of {sum(map(len, scores))} pair "
          f"scores); nodes "
          f"{n_nodes} edges {n_edges}; launches {launches}", flush=True)
    if launches != want:
        raise SystemExit(f"cli.infer spacenet: launches {launches}, expected {want}")
    if not all(n_nodes) or not all(n_edges):
        raise SystemExit("cli.infer spacenet: a tile's graph has no node or no edge")

    # The triage input, which no CLI writes: one record per test tile, its
    # cli.infer graph and its ground truth as normalised image (r, c) nodes,
    # and as smd the symmetric mean distance between the two node sets
    # (each node's distance to the other set's nearest, averaged each way,
    # over the tile's side); triage keeps every record above 0.
    records = []
    for tile, graph in graphs.items():
        with open(os.path.join(sat, f"{tile}__gt_graph.p"), "rb") as f:
            gt_nodes, gt_edges = sat2graph_rc(pickle.load(f))
        pred_nodes, pred_edges = sat2graph_rc(graph)
        smd = 0.5 * (cKDTree(gt_nodes).query(pred_nodes)[0].mean()
                     + cKDTree(pred_nodes).query(gt_nodes)[0].mean())
        records.append(dict(img_path=os.path.join(sat, f"{tile}__rgb.png"),
                            pred_nodes=pred_nodes, pred_edges=pred_edges, gt_nodes=gt_nodes,
                            gt_edges=gt_edges, smd=float(smd)))
    results = os.path.join(work, "inference_results.pickle")
    with open(results, "wb") as f:
        pickle.dump(records, f)
    triage_dir = os.path.join(work, "triage")
    random.seed(0)
    t = time.perf_counter()
    paths = triage.main(["--results", results, "--output_dir", triage_dir, "--sample_num",
                         str(len(records)), "--smd_threshold", "0"])
    seconds = time.perf_counter() - t
    names = sorted(f"smd_{r['smd']:.6f}_{os.path.basename(r['img_path'])}" for r in records
                   if r["smd"] > 0)
    shapes = {read_png(path).shape for path in paths}
    print(f"cli.triage: {len(paths)} images in {seconds:.2f} s, shapes {shapes}, smd "
          f"{[round(r['smd'], 4) for r in records]}", flush=True)
    if sorted(os.listdir(triage_dir)) != names or shapes != {(512, 2 * 512, 3)}:
        raise SystemExit(f"cli.triage: wrote {sorted(os.listdir(triage_dir))}, expected {names}")
    return dict(launches=launches, seconds_per_tile=loop_s / len(test_ids))


def run_labels_to_model(seed: int, dev: str = "cuda", extra: dict | None = None):
    """Phase 19: SpaceNet- and Cityscale-format ground truth -> cli.prepare
    -> cli.debug_labels -> cli.train (SPACENET_CONFIG, full width) ->
    cli.infer -> cli.triage. Returns K5's readings at the config's
    training shapes, K1-K4's at its inference shapes and the launches of
    the training and inference runs."""
    from sam_road_tpu_torch.data.partitions import cityscale_data_partition

    t0 = time.time()
    work = tempfile.mkdtemp(prefix="samroad_labels_")
    try:
        root = os.path.join(work, "data")
        t = time.perf_counter()
        spacenet = write_spacenet_tree(root, seed)
        print(f"19a: wrote {len(spacenet)} SpaceNet-format tiles in "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        spacenet_s = run_prepare(root, "spacenet", spacenet, 400, spacenet_xy)
        train_ids, _, _ = cityscale_data_partition()
        t = time.perf_counter()
        cityscale = write_cityscale_tree(root, seed, train_ids[:8])
        print(f"19b: wrote {len(cityscale)} Cityscale-format 2048 px tiles in "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        cityscale_s = run_prepare(root, "cityscale", cityscale, 2048, cityscale_xy)
        run_debug_labels(root, work)

        values = spacenet_values(extra)
        k5 = check_flash_attention(dev, cases=spacenet_flash_cases(values))
        trained = run_spacenet_train(root, work, dev, extra)
        infer_rows = check_kernels(int(values["INFER_BATCH_SIZE"]), dev,
                                   grid=int(values["PATCH_SIZE"]) // 16)
        inferred = run_spacenet_infer(root, work, trained, dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 19 took {time.time() - t0:.1f} s: prepare {spacenet_s:.4f} s per 400 px tile, "
          f"{cityscale_s:.4f} s per 2048 px tile; training {trained['step_s']:.4f} s a step "
          f"through the CLI ({trained['wait_s']:.4f} s of it the loader's wait), "
          f"{trained['clean_s']:.4f} s without a loader, "
          f"peak {trained['peak'] / 2 ** 30:.3f} GiB; inference "
          f"{inferred['seconds_per_tile']:.3f} s per tile | {gpu_line()}", flush=True)
    return dict(k5=k5, infer_rows=infer_rows, train_launches=trained["launches"],
                infer_launches=inferred["launches"])


def spacenet_flash_cases(values: dict):
    """K5's shapes under the config `values`: its windows (BATCH_SIZE
    patches of a 16 x 16 grid padded to 28 x 28: 4 windows of 14 x 14) and
    its 16 x 16 global grid, 12 heads of 64 at ViT-B."""
    b, grid = int(values["BATCH_SIZE"]), int(values["PATCH_SIZE"]) // 16
    heads, hd = 12, 64
    pad = -(-grid // 14) * 14
    return ((f"SpaceNet window 14x14 batch {b}", b * (pad // 14) ** 2, 14, heads, hd),
            (f"SpaceNet global {grid}x{grid} batch {b}", b, grid, heads, hd))


def check_tool_kernels(dev: str = "cuda", tokens: int = 32 * 1024, dim: int = 768,
                       windows: int = 32 * 9, win: int = 14, heads: int = 12):
    """Phase 11a: K9, K11, K12 and K13 at the tools' shapes (tokens [32768,
    768], hidden 3072; 288 windows of 14 x 14 tokens, 12 heads, bf16): each
    within TOL of its plain version in fp32, K11-K13 at groups 2 and 4
    bit-equal to group 1, K13 within TOL of K12 on the same tokens; times
    beside the bound, the plain version and SDPA with the bias as mask."""
    import torch

    from sam_road_tpu_torch.ops import fused_block, fused_ln

    gen = torch.Generator(device=dev).manual_seed(13)
    bf = torch.bfloat16

    def rn(*shape, scale=1.0, dt=bf):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

    C, N, hd = dim, win * win, dim // heads
    mlp = (rn(tokens, C), 1 + rn(C, scale=0.1), rn(C, scale=0.1), rn(4 * C, C, scale=C ** -0.5),
           rn(4 * C, scale=0.1), rn(C, 4 * C, scale=(4 * C) ** -0.5), rn(C, scale=0.1))
    qkv = rn(windows, N, 3 * C)
    tables = (rn(2 * win - 1, hd, scale=0.1), rn(2 * win - 1, hd, scale=0.1))
    split = tuple(t.contiguous() for t in fused_block._split_heads(qkv, heads))
    cases = {  # name -> (kernel, plain, inputs); K11-K13's kernels take group=
        "ln_mlp_residual": (fused_ln.ln_mlp_residual, fused_ln.ln_mlp_residual_plain, mlp),
        "window_attention_rows": (
            lambda *a, group=1: fused_block.window_attention_rows(*a, win, heads, group=group),
            lambda *a: fused_block.window_attention_rows_plain(*a, win, heads),
            (qkv, rn(windows, heads, N, win), rn(windows, heads, N, win))),
        "window_attention_relpos": (
            lambda *a, group=1: fused_block.window_attention_relpos(*a, win, heads, group=group),
            lambda *a: fused_block.window_attention_relpos_plain(*a, win, heads),
            (qkv,) + tables),
        "window_attention_relpos_batched": (
            lambda *a, group=1: fused_block.window_attention_relpos_batched(*a, win, group=group),
            lambda *a: fused_block.window_attention_relpos_batched_plain(*a, win),
            split + tables),
    }
    results, outs = {}, {}
    for name, (kern, plain, args) in cases.items():
        got = kern(*args)
        same = name == "ln_mlp_residual" or all(torch.equal(kern(*args, group=g), got)
                                                for g in (2, 4))
        if dev == "cuda":
            torch.cuda.synchronize()
        ref = plain(*[t.float() for t in args])
        err = (got.float() - ref).abs()
        max_abs, max_rel = err.max().item(), (err / (1 + ref.abs())).max().item()
        del ref, err
        row = timing_row(name, args, got, lambda: kern(*args), lambda: plain(*args))
        alone = ""
        if name == "ln_mlp_residual":
            alone = " " + fmt_device(with_device_time(row, lambda: kern(*args), dev))
            if dev == "cuda":
                alone += with_product_alone(row, name, args)
        ok = same and max_rel <= TOL and bool(torch.isfinite(got.float()).all())
        print(f"kernel {name}: shape {tuple(got.shape)} groups 2 and 4 bit-equal to 1 {same} "
              f"max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} (tol {TOL}) "
              f"{fmt_times(row)}{alone} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"kernel {name} disagrees with its plain version or across groups")
        results[name] = dict(max_abs_err=max_abs, **row)
        outs[name] = got
    k12 = outs["window_attention_relpos"].float()
    k13 = outs["window_attention_relpos_batched"].permute(0, 2, 1, 3).reshape(k12.shape).float()
    rel = ((k13 - k12).abs() / (1 + k12.abs())).max().item()
    print(f"K13 on split heads vs K12 on the window layout: max_rel_err {rel:.3e} (tol {TOL}) "
          f"{'ok' if rel <= TOL else 'FAIL'}", flush=True)
    if rel > TOL:
        raise SystemExit("window_attention_relpos_batched disagrees with window_attention_relpos")
    return results


def run_tools(dev: str = "cuda", shapes: dict = TOOL_SHAPES, profile_shapes: dict | None = None):
    """Phase 11b: the port's two tools in process, their main path: the
    kernel A/B (`tools/experiment_fused_ln.py all`) and the windowed-block
    profiler. Every kernel variant's L1 within 1e-2 of its plain
    counterpart's, every launch count exact; returns the launches."""
    from sam_road_tpu_torch.ops import _build
    from sam_road_tpu_torch.tools import experiment_fused_ln, profile_windowed_block

    _build.reset_launches()
    ab = experiment_fused_ln.main("all", dev, **shapes, **AB_LOOP)
    profile_windowed_block.main(dev, **(profile_shapes or {}), **PROFILE_LOOP)
    launches = dict(_build.launches)
    per_ab = 1 + AB_LOOP["iters"] * AB_LOOP["rounds"]
    per_stage = 1 + PROFILE_LOOP["iters"] * PROFILE_LOOP["rounds"]
    want = {  # ln_dense: cuda_ln_dense and all four stages; K2 in attn and full
        "ln_dense": per_ab + 4 * per_stage, "ln_mlp_residual": per_ab,
        "fused_attention": per_ab, "window_attention_relpos": per_ab,
        "window_attention_rows": 3 * per_ab, "window_attention_relpos_batched": per_ab,
        "window_attention_rows_grid": 2 * per_stage, "proj_ln_mlp_residual": per_stage}
    if dev != "cuda":
        want = {}  # the plain versions launch nothing
    ratios = {k: ab[f"{k}_l1"] / ab[f"{p}_l1"] for k, p in experiment_fused_ln.PAIRS.items()}
    print(f"tools: launches {launches}; L1 over the plain counterpart's {ratios}", flush=True)
    if launches != want:
        raise SystemExit(f"tools launches {launches}, expected {want}")
    if not all(abs(r - 1) <= 1e-2 for r in ratios.values()):
        raise SystemExit(f"a tool variant's L1 is off its plain counterpart's: {ratios}")
    return launches


def check_cases(cases: dict, heads: int, dev: str = "cuda") -> dict:
    """Each case label -> (kernel name, kernel, plain, args, equal, flops):
    kernel(*args) within TOL of plain on the args in fp32 and bit-equal to
    every output of the callables in `equal`; its timing row (`flops` where
    the name and args do not give them). Returns label -> row."""
    import torch

    results = {}
    for label, (name, kern, plain, args, equal, flops) in cases.items():
        got = kern(*args)
        same = all(torch.equal(f(), got) for f in equal)
        if dev == "cuda":
            torch.cuda.synchronize()
        ref = plain(*[t.float() for t in args])
        err = (got.float() - ref).abs()
        max_abs, max_rel = err.max().item(), (err / (1 + ref.abs())).max().item()
        del ref, err
        row = timing_row(name, args, got, lambda: kern(*args), lambda: plain(*args), flops=flops,
                         heads=heads)
        ok = same and max_rel <= TOL and bool(torch.isfinite(got.float()).all())
        print(f"kernel {label}: shape {tuple(got.shape)} bit-equal to {len(equal)} other "
              f"call(s) {same} max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} (tol {TOL}) "
              f"{fmt_times(row)} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"kernel {label} disagrees with its plain version or its variants")
        results[label] = dict(max_abs_err=max_abs, **row)
        del got
    return results


def check_vith_kernels(B: int, dev: str = "cuda"):
    """Phase 12a: K2, K10 (rolled, G 4), K3 and K11-K13 at vit_h's head_dim
    80, at its 256 px shapes (C 1280, 16 heads; B patches of a 16x16 grid
    padded to 28x28, 4 windows of 14 x 14 each; 256 global tokens): each
    within TOL of its plain version in fp32, K10 bit-equal to K2, K11-K13
    groups 2 and 4 bit-equal to 1; each row with the profiler's kernel time
    and the bound's share."""
    import torch

    from sam_road_tpu_torch.ops import attention, fused_block

    gen = torch.Generator(device=dev).manual_seed(18)
    bf = torch.bfloat16

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    C, heads, grid, win, gp = 1280, 16, 16, 14, 28
    hd, nw, N = C // heads, gp // win, win * win
    qkv_grid = torch.zeros((B, gp, gp, 3 * C), dtype=bf, device=dev)
    qkv_grid[:, :grid, :grid] = rn(B, grid, grid, 3 * C)
    rows = (B, nw, nw, heads, N, win)
    win_args = (qkv_grid, rn(3 * C, scale=0.5), rn(*rows), rn(*rows))
    nG = grid * grid
    g_args = ((rn(B, heads, nG, hd).float() * hd ** -0.5).to(bf), rn(B, heads, nG, hd),
              rn(B, heads, nG, hd), rn(B, heads, nG, grid), rn(B, heads, nG, grid))
    nW = B * nw * nw
    qkv = rn(nW, N, 3 * C)
    tables = (rn(2 * win - 1, hd, scale=0.1), rn(2 * win - 1, hd, scale=0.1))
    split = tuple(t.contiguous() for t in fused_block._split_heads(qkv, heads))

    def k2(*a, **mode):
        return fused_block.window_attention_rows_grid(*a, win, heads, **mode)

    def grid_plain(*a):
        return fused_block.window_attention_rows_grid_plain(*a, win, heads)

    def layout(kern, plain, args):  # K11-K13: groups 2 and 4 bit-equal to 1
        return kern, plain, args, [lambda g=g: kern(*args, group=g) for g in (2, 4)]

    cases = {  # name -> (kernel, plain, inputs, calls the kernel's output equals)
        "window_attention_rows_grid": (k2, grid_plain, win_args, []),
        "window_attention_rows_grid_rolled": (lambda *a: k2(*a, rolled_rows=True), grid_plain,
                                              win_args, [lambda: k2(*win_args)]),
        "window_attention_rows_grid_gbatch": (lambda *a: k2(*a, group_batch=4), grid_plain,
                                              win_args, [lambda: k2(*win_args)]),
        "attention_relpos_rows": (
            lambda *a: attention.attention_relpos_rows(*a, (grid, grid)),
            lambda *a: attention.attention_relpos_rows_plain(*a, (grid, grid)), g_args, []),
        "window_attention_rows": layout(
            lambda *a, group=1: fused_block.window_attention_rows(*a, win, heads, group=group),
            lambda *a: fused_block.window_attention_rows_plain(*a, win, heads),
            (qkv, rn(nW, heads, N, win), rn(nW, heads, N, win))),
        "window_attention_relpos": layout(
            lambda *a, group=1: fused_block.window_attention_relpos(*a, win, heads, group=group),
            lambda *a: fused_block.window_attention_relpos_plain(*a, win, heads),
            (qkv,) + tables),
        "window_attention_relpos_batched": layout(
            lambda *a, group=1: fused_block.window_attention_relpos_batched(*a, win, group=group),
            lambda *a: fused_block.window_attention_relpos_batched_plain(*a, win),
            split + tables),
    }
    rows = check_cases({name: (name, *case, None) for name, case in cases.items()}, heads, dev)
    for name, (kern, _, args, _) in cases.items():
        print(f"kernel {name} hd 80: "
              f"{fmt_device(with_device_time(rows[name], lambda: kern(*args), dev))}", flush=True)
    return rows


def vith_overrides() -> dict:
    """configs/toponet_vith_256.yaml's keys, as load_config overrides."""
    from sam_road_tpu_torch.config import read_flat_yaml

    return read_flat_yaml(VITH_CONFIG)


def check_vith_encoder(model, dev: str = "cuda", n: int = 4):
    """Phase 12b: vit_h's fused encoder (K1-K4 at head_dim 80, bf16) against
    its eager encoder through K5 (use_flash, bf16, D 80 + 28 in the windows
    and 80 + 32 in the global blocks) and against the eager encoder in fp32
    plain ops, on n random 256 px patches: every cosine >= COS_MIN; one
    fused forward launches K1 32, K2 28, K3 4, K4 32 times, one eager
    forward K5 32 times."""
    import torch
    import torch.nn.functional as F

    from sam_road_tpu_torch.models.fast_encoder import encoder_forward_fused
    from sam_road_tpu_torch.models.sam_road import PIXEL_MEAN, PIXEL_STD
    from sam_road_tpu_torch.ops import _build

    model = model.to(dev).eval()
    enc = model.image_encoder
    gen = torch.Generator(device=dev).manual_seed(19)
    p = enc.img_size
    rgb = torch.randint(0, 255, (n, p, p, 3), generator=gen, device=dev)
    attns = [blk.attn for blk in enc.blocks]
    flash, dtype = [a.use_flash for a in attns], enc.dtype
    launches = {}
    try:
        with torch.no_grad():
            _build.reset_launches()
            fused = encoder_forward_fused(enc, model.normalize(rgb)).float()
            launches["fused"] = dict(_build.launches)
            for a in attns:
                a.use_flash = True
            _build.reset_launches()
            eager = enc(model.normalize(rgb)).float()
            launches["eager"] = dict(_build.launches)
            for a in attns:
                a.use_flash = False
            enc.dtype = torch.float32
            mean = torch.tensor(PIXEL_MEAN, device=dev)
            exact = enc((rgb.float() - mean) / torch.tensor(PIXEL_STD, device=dev)).float()
    finally:
        for a, f in zip(attns, flash):
            a.use_flash = f
        enc.dtype = dtype
    cos = {name: F.cosine_similarity(a.flatten(), b.flatten(), dim=0).item()
           for name, a, b in (("fused vs eager K5", fused, eager), ("fused vs fp32", fused, exact),
                              ("eager K5 vs fp32", eager, exact))}
    want = {"fused": dict(VITH_PER_BATCH), "eager": {"fused_attention": len(attns)}}
    if dev != "cuda":
        want = {"fused": {}, "eager": {}}  # the plain versions launch nothing
    ok = (all(c >= COS_MIN for c in cos.values()) and launches == want
          and all(bool(torch.isfinite(t).all()) for t in (fused, eager)))
    print(f"vit_h encoder, {n} patches of {p} px, shape {tuple(fused.shape)}: cosine "
          + ", ".join(f"{k} {v:.6f}" for k, v in cos.items()) + f" (min {COS_MIN}); "
          f"launches {launches} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"vit_h's fused encoder disagrees with its eager encoder: {launches}")
    return cos


def check_t_kernels(dev: str = "cuda", windows: int = 32 * 9, win: int = 14, dim: int = 768,
                    heads: int = 12, groups=(2, 4, 8), folded_groups=(4, 16)):
    """Phase 13a: the tools' kernels at their tools' shapes against their
    plain versions in fp32: T1 on 288 windows of 14 x 14 (C 768, 12 heads)
    at g = 2, 4, 8; T2 over the (window, head) pairs of those windows
    (3456 x 196, q/k 92 wide, v 64) and T3 at G 4 and 16, each bit-equal to
    T2; T4 over the same pairs (q, k, v 64 wide, bias rows 14 wide). SDPA
    as the library call: per window with the bias as attn_mask (T1, T4),
    unscaled on the folded q and k (T2, T3)."""
    import torch

    from sam_road_tpu_torch.tools import (
        experiment_group_window as gw,
        experiment_relpos_kernel as rk,
        experiment_window_attn as wa,
    )

    gen = torch.Generator(device=dev).manual_seed(20)
    bf = torch.bfloat16

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    N, hd = win * win, dim // heads
    BH = windows * heads
    qkv = rn(windows, N, 3 * dim)
    rows = (rn(windows, heads, N, win), rn(windows, heads, N, win))
    folded = (rn(BH, N, hd + 2 * win, scale=0.3), rn(BH, N, hd + 2 * win, scale=0.3),
              rn(BH, N, hd))
    sel = (rn(BH, N, hd, scale=hd ** -0.5), rn(BH, N, hd), rn(BH, N, hd), rn(BH, N, win),
           rn(BH, N, win))
    cases = {}
    for g in groups:
        cases[f"diag_attn g{g}"] = (
            "diag_attn", lambda *a, g=g: gw.diag_attn(*a, g), lambda *a, g=g: gw.diag_attn_plain(
                *a, g), (qkv,) + rows, [], 4.0 * windows * heads * g * N * N * hd)
    cases["window_attn_kernel1"] = ("window_attn_kernel1", wa.window_attn_kernel1,
                                     wa.window_attn_plain, folded, [], None)
    for G in folded_groups:
        cases[f"window_attn_grouped G{G}"] = (
            "window_attn_grouped", lambda *a, G=G: wa.window_attn_grouped(*a, G),
            lambda *a, G=G: wa.window_attn_grouped_plain(*a, G), folded,
            [lambda: wa.window_attn_kernel1(*folded)], None)
    cases["sel_attention"] = ("sel_attention", rk.sel_attention, rk.sel_attention_plain, sel, [],
                              None)
    return check_cases(cases, heads, dev)


def run_t_tools(dev: str = "cuda", group_window: dict | None = None,
                window_attn: dict | None = None, relpos: dict | None = None):
    """Phase 13b: the three tools that carry T1-T4, in process, at their
    shapes (or the geometries given, to rehearse on the CPU): every
    variant's reldiff (T1) or L1 (T2-T4, against the plain formulation's)
    within 1e-2, every launch count exact; returns the launches."""
    from sam_road_tpu_torch.ops import _build
    from sam_road_tpu_torch.tools import (
        experiment_group_window as gw,
        experiment_relpos_kernel as rk,
        experiment_window_attn as wa,
    )

    _build.reset_launches()
    res_gw = gw.main(gw.GROUPS, dev, **(group_window or {}), **GROUP_WINDOW_LOOP)
    res_wa = wa.main(dev, **(window_attn or {}), **WINDOW_ATTN_LOOP)
    res_rk = rk.main(dev, **(relpos or {}), **RELPOS_LOOP)
    launches = dict(_build.launches)
    per_gw = 1 + GROUP_WINDOW_LOOP["iters"] * GROUP_WINDOW_LOOP["rounds"]
    per_wa = 1 + WINDOW_ATTN_LOOP["iters"] * WINDOW_ATTN_LOOP["reps"]
    per_rk = 1 + RELPOS_LOOP["iters"] * RELPOS_LOOP["reps"]
    want = {  # K11 is the T1 tool's reference (one more call); K5 is v0_current's attention
        "window_attention_rows": 1 + per_gw, "diag_attn": len(gw.GROUPS) * per_gw,
        "window_attn_kernel1": per_wa, "window_attn_grouped": len(wa.GROUPS) * per_wa,
        "fused_attention": per_rk, "sel_attention": per_rk}
    if dev != "cuda":
        want = {}  # the plain versions launch nothing
    rel = {k: v for k, v in res_gw.items() if k.endswith("_reldiff")}
    ratios = {k: res[f"{k}_l1"] / res[f"{p}_l1"]
              for res, pairs in ((res_wa, wa.PAIRS), (res_rk, rk.PAIRS)) for k, p in pairs.items()}
    print(f"tools T1-T4: launches {launches}; T1 reldiff against K11 {rel}; L1 over the plain "
          f"counterpart's {ratios}", flush=True)
    if launches != want:
        raise SystemExit(f"tools T1-T4 launches {launches}, expected {want}")
    if not all(r <= 1e-2 for r in rel.values()) or not all(
            abs(r - 1) <= 1e-2 for r in ratios.values()):
        raise SystemExit(f"a tool variant is off its reference: {rel} {ratios}")
    return launches


def peaked_rows(gen, dev: str, B: int, N: int, D: int):
    """q [B, N, D] bf16 whose row maxima of q[b] . q[b]^T lie off the
    diagonal: row n is s_n u_b plus noise, s_n in [-1, 1] but 3 at row
    37 b % N and -3 at row (37 b + N / 2) % N, so nearly every row's max is
    at one of those two, in a key tile that moves with b (T7 on a = b = q
    with random rows finds each max on the diagonal, whatever key tiles the
    kernel visits)."""
    import torch

    s = torch.rand((B, N), generator=gen, device=dev) * 2 - 1
    b = torch.arange(B, device=dev)
    s[b, 37 * b % N] = 3.0
    s[b, (37 * b + N // 2) % N] = -3.0
    u = torch.randn((B, 1, D), generator=gen, device=dev)
    noise = torch.randn((B, N, D), generator=gen, device=dev)
    return (s[..., None] * u + 0.1 * noise).to(torch.bfloat16)


def check_t58_kernels(dev: str = "cuda", windows: int = 32 * 9, win: int = 14, dim: int = 768,
                      heads: int = 12, batch: int = 32, grid: int = 32, merge_tokens=(196, 200),
                      tokens: int = 200, width: int = 768):
    """Phase 14a: T5-T8 at their tools' shapes against their plain versions
    in fp32: T5 over the (window, head) pairs of 288 windows of 14 x 14
    (3456 x 196, head_dim 64) and over the global grid (32 images x 12
    heads, 1024 tokens), unscaled q and the expanded tables; T6 at NP 196
    and 200 (x [32, NP, 256], W [256, 256]); T7 on q [32, 200, 64], random
    and `peaked_rows` (its key loop); T8 on x [8, 200, 768]. Library calls: SDPA with the bias as attn_mask (T5),
    torch.matmul (T6), torch.bmm and amax (T7, T8). Each row also carries
    `device_ms`, the kernel's own time from the profiler: T6-T8 are bound by
    their launches; T7's and T8's rows also `library` (T58_LIBRARY) and
    `host_us` / `library_host_us`, a call's time on the host's clock
    (host_us)."""
    import torch

    from sam_road_tpu_torch.ops.fused_block import expand_rel_pos
    from sam_road_tpu_torch.tools import experiment_block_variants as bv, probe_mosaic as pm

    gen = torch.Generator(device=dev).manual_seed(24)
    bf = torch.bfloat16

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    hd, C = dim // heads, 256
    cases = {}
    for label, BH, side in (("global", batch * heads, grid), ("window", windows * heads, win)):
        N = side * side
        args = tuple(rn(BH, N, hd) for _ in range(3)) + expand_rel_pos(
            rn(2 * side - 1, hd, scale=0.1), rn(2 * side - 1, hd, scale=0.1), side, bf)
        cases[f"inker_attention {label}"] = (
            "inker_attention", lambda *a, s=side: bv.inker_attention(*a, s, s),
            lambda *a, s=side: bv.inker_attention_plain(*a, s, s), args, [], None)
    for NP in merge_tokens:
        cases[f"merge_dense NP{NP}"] = ("merge_dense", pm.merge_dense, pm.merge_dense_plain,
                                        (rn(batch, NP, C), rn(C, C)), [], None)
    cases["batched_dot"] = ("batched_dot", pm.batched_dot, lambda q: pm.rowmax_dot_plain(q, q),
                            (rn(batch, tokens, pm.HEAD),), [], None)
    cases["batched_dot peaked"] = ("batched_dot", pm.batched_dot,
                                   lambda q: pm.rowmax_dot_plain(q, q),
                                   (peaked_rows(gen, dev, batch, tokens, pm.HEAD),), [], None)
    cases["lane_slice"] = ("lane_slice", pm.lane_slice, lambda x: pm.rowmax_dot_plain(
        x[..., :pm.HEAD], x[..., pm.HEAD:2 * pm.HEAD]), (rn(batch // 4, tokens, width),), [], None)
    rows = check_cases(cases, heads, dev)
    for label, (name, kern, _, args, _, _) in cases.items():
        row = with_device_time(rows[label], lambda: kern(*args), dev)
        host = ""
        if name in T58_LIBRARY:
            with torch.no_grad():
                row["host_us"], row["library_host_us"] = host_us(
                    [lambda: kern(*args), library_call(name, args)], dev=dev)
            row["library"] = T58_LIBRARY[name]
            host = f" host_us {row['host_us']:.2f} (library {row['library_host_us']:.2f})"
        print(f"kernel {label}: {fmt_device(row)} against ms {row['ms']:.4f} (CUDA events)"
              f"{host}", flush=True)
    return rows


def run_t58_tools(dev: str = "cuda", block: dict | None = None, probe: dict | None = None):
    """Phase 14b: experiment_block_variants and probe_mosaic in process, at
    their shapes (or the geometries given, to rehearse on the CPU): every
    block variant's L1 within 1e-2 of the xla block's, every probe "OK",
    every launch count exact; returns the launches."""
    from sam_road_tpu_torch.ops import _build
    from sam_road_tpu_torch.tools import experiment_block_variants as bv, probe_mosaic as pm

    _build.reset_launches()
    res_bv = bv.main(dev, **(block or {}), **BLOCK_LOOP)
    res_pm = pm.main(dev, **(probe or {}), reps=PROBE_REPS)
    launches = dict(_build.launches)
    per_block = 1 + BLOCK_LOOP["iters"] * BLOCK_LOOP["reps"]
    per_probe = 1 + PROBE_REPS
    want = {  # K5 is the flash blocks' attention, windowed and global
        "inker_attention": 2 * per_block, "fused_attention": 2 * per_block,
        "merge_dense": 2 * per_probe, "batched_dot": per_probe, "lane_slice": per_probe}
    if dev != "cuda":
        want = {}  # the plain versions launch nothing
    ratios = {k: res_bv[f"{k}_l1"] / res_bv[f"{p}_l1"] for k, p in bv.PAIRS.items()}
    answers = {k: v for k, v in res_pm.items() if isinstance(v, str)}
    print(f"tools T5-T8: launches {launches}; L1 over the xla block's {ratios}; probes "
          f"{answers}", flush=True)
    if launches != want:
        raise SystemExit(f"tools T5-T8 launches {launches}, expected {want}")
    if not all(abs(r - 1) <= 1e-2 for r in ratios.values()):
        raise SystemExit(f"a block variant's L1 is off the xla block's: {ratios}")
    if len(answers) != 4 or any(v != "OK" for v in answers.values()):
        raise SystemExit(f"a probe did not pass: {answers}")
    return launches


def check_t913_kernels(dev: str = "cuda", batch: int = 2, rows: int = 32, width: int = 32,
                       channels: int = 256, win: int = 14, heads: int = 12, tokens: int = 256,
                       depth: int = 64, more=T13_MORE):
    """Phase 15a: T9-T13 at their tools' shapes against their plain versions
    in fp32: T9 (x [2, 32, 32, 256] in blocks of 14 rows, out 42 rows) and
    T10 (out exactly 32 rows) bit-equal, T10 also through a view of 32 rows
    of a buffer whose rows past H hold NaN, which must stay NaN; T11 (x [2,
    14, 32, 256] -> [2, 14, 3, 256]) within 1e-4, T12 bit-equal to T11;
    T13 (a, b [12, 256, 64] bf16, then each (heads, N) of `more`) looped and
    batched within TOL (1 + |ref|), bit-equal to each other, the looped grid
    min(SMs, items) blocks and the batched one a block per item. Library
    calls: F.pad + 1 (T9), x * 2 (T10), F.pad and a sum over the window
    (T11, T12), torch.bmm (T13). Each row also carries `device_ms`, the
    kernels' own time from the profiler, and `host_us` / `library_host_us`,
    a call's time on the host's clock (host_us): these kernels are bound by
    their launches."""
    import torch

    from sam_road_tpu_torch.tools import probe_nondiv_blocks as pnb, repro_aot_crash as rac

    gen = torch.Generator(device=dev).manual_seed(26)
    x_rows = torch.randn((batch, rows, width, channels), generator=gen, device=dev)
    x_win = torch.randn((batch, win, width, channels), generator=gen, device=dev)
    out_rows = -(-rows // win) * win
    nJ = -(-width // win)
    affine = 2.0 * batch * out_rows * width * channels  # T9: a multiply and an add an output
    sums = float(batch * win * nJ * win * channels)  # T11, T12: an add a term
    # label -> (kernel name, kernel, plain, args, atol, rtol, equal, flops, peak)
    cases = {
        "nondiv_read_write": (
            "nondiv_read_write", lambda x: pnb.nondiv_read_write(x, win),
            lambda x: pnb.row_block_affine_plain(x, out_rows, 1.0, 1.0), (x_rows,), 0.0, 0.0,
            [], affine, PEAK_FP32),
        "nondiv_out_exact": (
            "nondiv_out_exact", lambda x: pnb.nondiv_out_exact(x, win),
            lambda x: pnb.row_block_affine_plain(x, rows, 2.0, 0.0), (x_rows,), 0.0, 0.0, [],
            affine * rows / out_rows, PEAK_FP32),
        "inkernel_pad_loop": (
            "inkernel_pad_loop", lambda x: pnb.inkernel_pad_loop(x, win),
            lambda x: pnb.window_colsum_plain(x, win), (x_win,), pnb.SUM_TOL, 0.0, [], sums,
            PEAK_FP32),
        "oversized_sublane_block": (
            "oversized_sublane_block", lambda x: pnb.oversized_sublane_block(x, win),
            lambda x: pnb.window_colsum_plain(x, win), (x_win,), pnb.SUM_TOL, 0.0,
            [lambda: pnb.inkernel_pad_loop(x_win, win)], sums, PEAK_FP32),
    }
    grids = {}
    for h, n in ((heads, tokens),) + tuple(more):
        a, b = (torch.randn((h, n, depth), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        where = "" if (h, n) == (heads, tokens) else f" [{h}, {n}, {depth}]"
        for shape in rac.SHAPES:
            other = [lambda a=a, b=b, s=s: rac.batched_nt(a, b, looped=s == "looped")
                     for s in rac.SHAPES if s != shape]
            cases[f"batched_nt {shape}{where}"] = (
                "batched_nt", lambda a, b, s=shape: rac.batched_nt(a, b, looped=s == "looped"),
                rac.batched_nt_plain, (a, b), TOL, TOL, other, 2.0 * h * n * n * depth,
                PEAK_FLOPS)
        if dev == "cuda":
            grids[(h, n)] = {s: rac.batched_nt_grid(h, n, s == "looped") for s in rac.SHAPES}
    if dev == "cuda":  # the looped grid: one block an SM at most, the batched one an item each
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for (h, n), got in grids.items():
            items = h * (-(-n // 64)) ** 2
            print(f"batched_nt [{h}, {n}, {depth}]: {items} items; grid {got} on {sms} SMs",
                  flush=True)
            if got != {"looped": min(sms, items), "batched": items}:
                raise SystemExit(f"batched_nt [{h}, {n}] launches grids {got}, expected looped "
                                 f"min({sms}, {items}) and batched {items}")
    results = {}
    for label, (name, kern, plain, args, atol, rtol, equal, flops, peak) in cases.items():
        got = kern(*args)
        same = all(torch.equal(f(), got) for f in equal)
        if dev == "cuda":
            torch.cuda.synchronize()
        ref = plain(*[t.float() for t in args])
        err = (got.float() - ref).abs()
        max_abs = err.max().item()
        within = bool((err <= atol + rtol * ref.abs()).all())  # atol = rtol = 0: bit-equal
        del err
        row = timing_row(name, args, got, lambda: kern(*args), lambda: plain(*args), flops=flops,
                         heads=heads, win=win, peak=peak)
        row["device_ms"] = device_ms(lambda: kern(*args)) if dev == "cuda" else None
        with torch.no_grad():
            row["host_us"], row["library_host_us"] = host_us(
                [lambda: kern(*args), library_call(name, args, win=win, heads=heads)], dev=dev)
        ok = same and within and bool(torch.isfinite(got.float()).all())
        print(f"kernel {label}: shape {tuple(got.shape)} bit-equal to {len(equal)} other "
              f"call(s) {same} max_abs_err {max_abs:.3e} (atol {atol}, rtol {rtol}) "
              f"{fmt_times(row)} device_ms {row['device_ms']} host_us {row['host_us']:.2f} "
              f"(library {row['library_host_us']:.2f}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"kernel {label} disagrees with its plain version or its variants")
        results[label] = dict(max_abs_err=max_abs, library=T913_LIBRARY[name], **row)
        del got, ref
    # T10 through a view of H rows: the partial block's rows past H are never written
    buf = torch.full((batch, rows + pnb.GUARD_ROWS, width, channels), float("nan"), device=dev)
    pnb.nondiv_out_exact(x_rows, win, out=buf[:, :rows])
    exact = torch.equal(buf[:, :rows], pnb.row_block_affine_plain(x_rows, rows, 2.0, 0.0))
    guard = bool(torch.isnan(buf[:, rows:]).all())
    print(f"kernel nondiv_out_exact through a view of {rows} rows: bit-equal to plain {exact}, "
          f"the {pnb.GUARD_ROWS} guard rows past H of each image still NaN {guard}", flush=True)
    if not (exact and guard):
        raise SystemExit("nondiv_out_exact wrote past its output's rows or disagrees with plain")
    results["nondiv_out_exact"]["guard_rows_untouched"] = guard
    if dev == "cuda":
        results["nondiv_out_exact"]["host_split"] = t913_host_split(x_rows)
        results["batched_nt looped"]["host_split"] = t913_host_split(*cases["batched_nt looped"][3])
    return results


def t913_host_split(*args, reps: int = 100) -> dict:
    """Where a call of T10 (args: x) or T13 looped (args: a, b) spends its
    host time: each step of the wrapper's CUDA path alone, in the wrapper's
    order, as microseconds a call on the host's clock (`alone_us`: host_us,
    each step's calls in a row) and from torch.profiler's CPU events
    (`profiler_us`: a record_function range around each step, reps calls
    of the sequence; the range's own cost is the "range" step's reading,
    and the profiler's per-op overhead is inside). Three steps are what
    the wrappers ran before they were cut: "torch.empty" (now empty_like /
    new_empty), "out checks" (now only for an `out` the caller gave) and
    "stream (torch.cuda)" (before _build.stream_of read the raw stream).
    Nothing here is counted as a launch."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from sam_road_tpu_torch.ops import _build
    from sam_road_tpu_torch.tools import probe_nondiv_blocks as pnb

    counts = collections.Counter()
    x = args[0]
    stream = _build.stream_of(x)
    lib = _build.kernels()

    def count():
        counts["split"] += 1

    if len(args) == 1:  # T10: 2 x into a new tensor of x's shape
        B, H, W, C = x.shape
        out = torch.empty_like(x)
        steps = {
            "on_cpu": lambda: _build.on_cpu(x),
            "require x": lambda: _build.require(x, "x", torch.float32),
            "empty_like": lambda: torch.empty_like(x),
            "torch.empty": lambda: torch.empty((B, H, W, C), dtype=torch.float32,
                                               device=x.device),
            "out checks": lambda: pnb.check_out(out, x, H, "split"),
            "kernels()": lambda: _build.kernels().samroad_row_block_affine,
            "stream_of": lambda: _build.stream_of(x),
            "stream (torch.cuda)": lambda: (torch.cuda.current_device(),
                                            torch.cuda.current_stream(x.device).cuda_stream),
            "ctypes launch": lambda: lib.samroad_row_block_affine(
                x.data_ptr(), out.data_ptr(), B, H, H, W * C, out.stride(0), 2.0, 0.0, stream),
            "check": lambda: _build.check(0, "split"),
            "count": count,
        }
    else:  # T13 looped
        a, b = args
        heads, N, D = a.shape
        out = a.new_empty((heads, N, N))
        steps = {
            "on_cpu": lambda: _build.on_cpu(a),
            "require a, b": lambda: (_build.require(a, "a", torch.bfloat16),
                                     _build.require(b, "b", torch.bfloat16, a.shape)),
            "new_empty": lambda: a.new_empty((heads, N, N)),
            "torch.empty": lambda: torch.empty((heads, N, N), dtype=a.dtype, device=a.device),
            "kernels()": lambda: _build.kernels().samroad_batched_nt,
            "stream_of": lambda: _build.stream_of(a),
            "stream (torch.cuda)": lambda: (torch.cuda.current_device(),
                                            torch.cuda.current_stream(a.device).cuda_stream),
            "ctypes launch": lambda: lib.samroad_batched_nt(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), heads, N, D, 1, stream),
            "check": lambda: _build.check(0, "split"),
            "count": count,
        }
    steps = {"range": lambda: None, **steps}
    split = {name: dict(alone_us=us) for name, us in zip(steps, host_us(list(steps.values())))}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(reps):
            for name, f in steps.items():
                with record_function("split " + name):
                    f()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.key.startswith("split ") and e.key[6:] in split:
            split[e.key[6:]]["profiler_us"] = e.cpu_time_total / e.count
    print("host split " + ("T10" if len(args) == 1 else "T13 looped") + ": " + ", ".join(
        f"{k} {v['alone_us']:.2f} / {v.get('profiler_us', float('nan')):.2f}"
        for k, v in split.items()) + " (us a call alone / in profiler ranges)", flush=True)
    return split


def run_t913_tools(dev: str = "cuda", nondiv: dict | None = None, repro: dict | None = None):
    """Phase 15b: probe_nondiv_blocks (its main: Q1-Q4; then
    probe_oversized_sublane_block, which the JAX script defines but never
    calls) and repro_aot_crash in process, at their shapes (or the
    geometries given, to rehearse on the CPU): every verdict True, both
    shapes "PASS", every launch count exact; returns the launches."""
    from sam_road_tpu_torch.ops import _build
    from sam_road_tpu_torch.tools import probe_nondiv_blocks as pnb, repro_aot_crash as rac

    nondiv = nondiv or {}
    _build.reset_launches()
    res_nd = pnb.main(dev, **nondiv, reps=PROBE_REPS)
    res_nd.update(pnb.probe_oversized_sublane_block(
        dev, **{k: v for k, v in nondiv.items() if k != "rows"}, reps=PROBE_REPS))
    res_rac = rac.main(dev, **(repro or {}), reps=PROBE_REPS)
    launches = dict(_build.launches)
    per = 1 + PROBE_REPS
    want = {"nondiv_read_write": per, "nondiv_out_exact": per, "inkernel_pad_loop": per,
            "oversized_sublane_block": per, "batched_nt": len(rac.SHAPES) * per}
    if dev != "cuda":
        want = {}  # the plain versions launch nothing
    verdict = {k: v for k, v in res_nd.items() if isinstance(v, bool)}
    answers = {k: v for k, v in res_rac.items() if isinstance(v, str)}
    print(f"tools T9-T13: launches {launches}; probe verdicts {verdict}; repro {answers}",
          flush=True)
    if launches != want:
        raise SystemExit(f"tools T9-T13 launches {launches}, expected {want}")
    if len(verdict) != 4 or not all(verdict.values()):
        raise SystemExit(f"a non-dividing block probe did not pass: {verdict}")
    if len(answers) != len(rac.SHAPES) or any(v != "PASS" for v in answers.values()):
        raise SystemExit(f"a batched-product shape did not pass: {answers}")
    return launches


def check_times(tool: str, result: dict) -> None:
    """Every time in a tool's result (a number, or a list of them, under a
    key ending in _s, _ms or _rounds) positive and finite."""
    bad = []

    def walk(key, v):
        if isinstance(v, dict):
            for k, x in v.items():
                walk(k, x)
        elif isinstance(v, list):
            for x in v:
                walk(key, x)
        elif key.endswith(("_s", "_ms", "_rounds")) and not (math.isfinite(v) and v > 0):
            bad.append((key, v))

    walk("", result)
    if bad:
        raise SystemExit(f"{tool}: times not positive and finite: {bad[:5]}")


def run_profilers(dev: str = "cuda", engine: dict | None = None, encoder: dict | None = None,
                  batches=SWEEP_BATCHES, rounds: int = PROFILE_ROUNDS):
    """Phase 21: the inference measurement tools of sam_road_tpu_torch/tools/
    at the bench geometry, each printing its JSON line: profile_phase1
    (fused), profile_extract_p2, profile_phase2 (S 128), abtest_engine
    (B = AB_B), experiment_infer_batch (`batches`, the fused encoder on and
    off) and profile_encoder, with `rounds` rounds (repetitions, reps) each.
    Every time positive and finite; the sweep's check runs launch K1-K4 (or
    K5 with the fused encoder off) exactly as a region needs; the A/B's
    graphs non-empty. `engine` (overrides, region) and `encoder` (batch,
    img_size, sam_version) shrink the tools for a CPU rehearsal."""
    from sam_road_tpu_torch.tools import (abtest_engine, experiment_infer_batch,
                                          profile_encoder, profile_extract_p2, profile_phase1,
                                          profile_phase2)

    engine, encoder = engine or {}, encoder or {}
    out = {}
    for name, fn in (
            ("profile_phase1", lambda: profile_phase1.main(dev, rounds=rounds, **engine)),
            ("profile_extract_p2", lambda: profile_extract_p2.main(dev, reps=rounds, **engine)),
            ("profile_phase2", lambda: profile_phase2.main(
                128, dev, rounds=rounds, overrides=engine.get("overrides"))),
            ("abtest_engine", lambda: abtest_engine.main(
                AB_B, rounds, {}, dev, base=engine.get("overrides"),
                region=engine.get("region"))),
            ("experiment_infer_batch", lambda: experiment_infer_batch.main(
                batches, dev, runs=SWEEP_RUNS, **engine)),
            ("profile_encoder", lambda: profile_encoder.main(dev, rounds=rounds, **encoder))):
        t = time.time()
        out[name] = fn()
        check_times(name, out[name])
        print(f"{name} took {time.time() - t:.1f} s", flush=True)
    for key, row in out["experiment_infer_batch"].items():
        if key == "device":
            continue
        b = int(key[1:].split("_")[0])
        patches = out["profile_phase1"]["patches"]
        per_batch = BENCH_PER_BATCH if key.endswith("_fused") else {"fused_attention": 12}
        want = {k: n * -(-patches // b) for k, n in per_batch.items()}
        if dev == "cuda" and row["launches"] != want:
            raise SystemExit(f"experiment_infer_batch {key}: launches {row['launches']}, "
                             f"expected {want}")
    if not all(out["abtest_engine"]["a_graph"] + out["abtest_engine"]["b_graph"]):
        raise SystemExit(f"abtest_engine: an empty graph {out['abtest_engine']}")
    return out


def check_arm(name: str, res: dict) -> dict:
    """One phase-23 arm's A/B result: printed, and refused unless arm B's
    masks, nodes and edges equal arm A's and the graph is not empty."""
    print(f"{name}: A least {res['a_min']} s median {res['a_median']} s; B least "
          f"{res['b_min']} s median {res['b_median']} s; paired median A - B "
          f"{res['paired_delta_median']} s; graph {res['b_graph']}; B's last timings "
          f"{res['b_timings'][-1]}; A's {res['a_timings'][-1]}"
          + (f"; speculation {res['b_spec_last']}" if "b_spec_last" in res else "")
          + (f"; device aggregation {res['b_agg_last']}" if "b_agg_last" in res else ""),
          flush=True)
    if not res["same_outputs"]:
        raise SystemExit(f"{name}: arm B's masks, nodes or edges differ from arm A's")
    if not all(res["a_graph"] + res["b_graph"]):
        raise SystemExit(f"{name}: an empty graph {res['a_graph']} / {res['b_graph']}")
    return res


def spec_region(img: np.ndarray, masks_of, frontier: int):
    """The region and thresholds where the speculative phase 2 must hit:
    `img` with its columns from `frontier` (the last band's anchor) on
    black, and each threshold half a level above its mask's maximum there
    (`masks_of(region)`: the (keypoint, road) uint8 masks at thresholds
    1.0). No candidate then lies right of the frontier, so the provisional
    vertices are the final ones. Elsewhere they are not: the final NMS
    visits tied priorities in np.argsort's order, which moves with the
    candidate count, so a vertex anywhere may change."""
    region = img.copy()
    region[:, frontier:] = 0
    kp, road = masks_of(region)
    return region, dict(ITSC_THRESHOLD=(float(kp[:, frontier:].max()) + 0.5) / 255.0,
                        ROAD_THRESHOLD=(float(road[:, frontier:].max()) + 0.5) / 255.0)


def run_pipeline_modes(seed: int, dev: str = "cuda", base: dict | None = None,
                       region: int = REGION, agg_region: int = AGG_REGION,
                       rounds: int = PIPELINE_ROUNDS, per_batch: dict = BENCH_PER_BATCH,
                       tiles: int = TILES, tile: int = TILE):
    """Phase 23: the engine's pipeline modes over the bench workload (BENCH
    plus `base`, seeded weights, the rng(0) region). First the default
    config once, at the bench tool's thresholds: its stream plan, its
    batches and its launches (`per_batch` of each kernel a batch); that
    run is the phase's warm run. Then every arm of PIPELINE_ARMS as an arm
    B of abtest_engine.arms against A = PIPELINE_A (`rounds` rounds, each
    every arm and then A, at the same thresholds, no warm runs of their
    own, the outputs of the last round compared); the device aggregation
    again on an `agg_region` px region (thresholds calibrated on it, which
    warms it), where it must engage; the speculative phase 2 on
    spec_region's region, where it must hit; and `tiles` regions of `tile`
    px through infer_tiles against one by one, equal. Any arm whose outputs
    differ from A's ends the run. Returns {"launches", "plan", "arms",
    "tiles"}."""
    from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random
    from sam_road_tpu_torch.ops import _build
    from sam_road_tpu_torch.tools import abtest_engine, bench

    base = base or {}
    model = init_random(SAMRoad.from_config(bench.bench_config(base)), seed)
    img = bench.make_region(region)
    engine = bench.make_engine(dev, base, model)
    thresholds = calibrate(engine, img)
    _build.reset_launches()
    p1 = engine._run_phase1(img)
    nodes, edges, _, _ = engine._finish(p1)
    launches = dict(_build.launches)
    plan, batches = p1["plan"], len(p1["batches"])
    columns = [(b["i0"], b["i1"]) for b in plan] if plan else None
    print(f"the default config on the {region} px region: stream plan {plan} (patch index "
          f"ranges {columns}), {batches} batches, {len(p1['masks'])} mask chunks; nodes "
          f"{nodes.shape[0]} edges {edges.shape[0]}; timings {engine.last_timings}; "
          f"launches {launches}", flush=True)
    if plan is None:
        raise SystemExit("the default config did not take the streamed phase 1")
    want = {k: n * batches for k, n in per_batch.items()}
    if launches != want:
        raise SystemExit(f"streamed region launches {launches}, expected {want}")
    del engine, p1
    t = time.time()
    arms = abtest_engine.arms(PIPELINE_ARMS, rounds, PIPELINE_A, dev, model=model, base=base,
                              region=img, thresholds=thresholds, warm=False)
    for name, res in arms.items():
        check_arm(name, res)
    print(f"the {len(arms)} arms took {time.time() - t:.1f} s", flush=True)
    name = f"device_agg_{agg_region}px"
    arms[name] = check_arm(name, abtest_engine.main(
        PIPELINE_ARMS["device_agg"], rounds, PIPELINE_A, dev, model=model, base=base,
        region=bench.make_region(agg_region), warm=False))
    agg = {k: arms[k].get("b_agg_last") for k in ("device_agg", name)}
    print(f"device aggregation by region (E unique directed edges, E_pad the "
          f"accumulator's rows, path taken): {agg}", flush=True)
    if not any(a and a["path"] == "device" for a in agg.values()):
        raise SystemExit(f"the device aggregation engaged on no region: {agg}")

    whole = bench.make_engine(dev, {**base, **PIPELINE_A}, model)

    def masks_of(r):
        whole.config.ITSC_THRESHOLD = whole.config.ROAD_THRESHOLD = 1.0
        return whole.infer_one_img(r)[2:]

    spec_img, spec_thresholds = spec_region(img, masks_of, plan[-1]["a"])
    name = "speculative_hits"
    arms[name] = check_arm(name, abtest_engine.main(
        PIPELINE_ARMS["speculative"], 1, PIPELINE_A, dev, model=model, base=base,
        region=spec_img, thresholds=spec_thresholds, warm=False))
    spec = {k: arms[k]["b_spec_last"] for k in ("speculative", name)}
    print(f"speculation by region (the bench region; its columns from {plan[-1]['a']} "
          f"black at thresholds {spec_thresholds}): {spec}", flush=True)
    if spec[name]["spec_hits"] < 1:
        raise SystemExit(f"the speculative phase 2 hit on no region: {spec}")
    del whole

    engine = bench.make_engine(dev, base, model)
    regions = [np.random.default_rng(s).integers(0, 255, (tile, tile, 3), dtype=np.uint8)
               for s in range(1, tiles + 1)]
    calibrate(engine, regions[0])
    t = time.time()
    tiled = list(engine.infer_tiles(regions))
    tiled_s = time.time() - t
    t = time.time()
    single = [engine.infer_one_img(r) for r in regions]
    single_s = time.time() - t
    print(f"infer_tiles over {tiles} regions of {tile} px: {tiled_s:.3f} s, one by one "
          f"{single_s:.3f} s", flush=True)
    for a, b in zip(tiled, single):
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise SystemExit("infer_tiles differs from infer_one_img")
    return dict(launches=launches, plan=plan, arms=arms,
                tiles=dict(tiles=tiles, tile=tile, tiled_s=tiled_s, single_s=single_s))


def k6_per_forward(depth: int, n_global: int) -> dict:
    """K6's launches in one FUSED_ENCODER_TRAIN forward of an encoder of
    `depth` blocks, `n_global` of them global: each wrapper and the kernel
    its forward launches."""
    w = depth - n_global
    return {"ln_dense_d": w, "ln_dense_bias_d": n_global, "proj_ln_mlp_residual_d": depth,
            "window_attention_rows_grid_d": w, "attention_relpos_rows_d": n_global,
            "ln_dense": depth, "window_attention_rows_grid": w,
            "attention_relpos_rows": n_global, "proj_ln_mlp_residual": depth}


def encoder_shape(config) -> tuple:
    """(depth, global blocks) of the config's encoder."""
    from sam_road_tpu_torch.models.vit import ENCODER_SPECS

    spec = ENCODER_SPECS[str(config.SAM_VERSION)]
    return spec["depth"], len(spec["global_attn_indexes"])


def positive_times(label: str, values) -> None:
    if not values or not all(math.isfinite(v) and v > 0 for v in values):
        raise SystemExit(f"{label}: times or rates not positive and finite: {values}")


def check_steps(label: str, run: dict, want: dict | None, min_steps: int, peak=None) -> None:
    """A tool's training run (`losses`, `grad_norms`, `skipped`, `moved`,
    `launches`): at least `min_steps` steps, every loss and grad_norm
    finite, none skipped, every watched parameter moved, and the launches
    `want` (None: not checked, as off the card)."""
    peak_text = "none" if peak is None else f"{peak:.3f}"
    print(f"{label}: losses {', '.join(f'{x:.4f}' for x in run['losses'])}; grad_norms "
          f"{', '.join(f'{x:.4f}' for x in run['grad_norms'])}; moved {run['moved']}; "
          f"launches {run['launches']}; peak memory allocated {peak_text} GiB", flush=True)
    values = run["losses"] + run["grad_norms"]
    if len(run["losses"]) < min_steps or not all(np.isfinite(values)) or run["skipped"]:
        raise SystemExit(f"{label}: fewer than {min_steps} steps, a loss or grad_norm not "
                         "finite, or a step skipped")
    if not run["moved"] or not all(v > 0 for v in run["moved"].values()):
        raise SystemExit(f"{label}: a watched parameter did not move: {run['moved']}")
    if want is not None and run["launches"] != want:
        raise SystemExit(f"{label}: launches {run['launches']}, expected {want}")


def check_fused_ab(label: str, out: dict, config, dev: str) -> None:
    """experiment_fused_train's two arms: each its steps' checks, the eager
    arm through K5 alone, the fused arm through K6 alone."""
    depth, n_global = encoder_shape(config)
    steps = len(out["eager"]["losses"])
    want_a = {"fused_attention": depth * steps} if dev == "cuda" else None
    want_b = ({k: v * steps for k, v in k6_per_forward(depth, n_global).items()}
              if dev == "cuda" else None)
    check_steps(f"{label} eager (K5)", out["eager"], want_a, 3, out["peak_gib"])
    check_steps(f"{label} FUSED_ENCODER_TRAIN (K6)", out["fused"], want_b, 3, out["peak_gib"])
    positive_times(label, out["eager_s_per_step"] + out["fused_s_per_step"])


def check_memory_rows(label: str, res: dict, depth: int, steps: int, dev: str) -> dict:
    """experiment_train_memory's rows: each configuration's steps (K5
    launched by every block of every forward, and again in the backward
    under REMAT_ENCODER; none without FLASH_ATTENTION) and a peak above the
    arguments on the card. Returns the rows."""
    rows = {k: v for k, v in res.items() if k != "device"}
    for key, row in rows.items():
        flash, remat = (bool(int(part[-1])) for part in key.split("_"))
        want = None
        if dev == "cuda":
            want = {"fused_attention": depth * steps * (2 if remat else 1)} if flash else {}
            if not row["peak_mb"] > row["arg_mb"] > 0:
                raise SystemExit(f"{label} {key}: peak {row['peak_mb']} MiB is not above the "
                                 f"arguments' {row['arg_mb']} MiB")
        check_steps(f"{label} {key}", row, want, steps + 1,
                    None if row["peak_mb"] is None else row["peak_mb"] / 2 ** 10)
    return rows


def run_train_tools(seed: int, dev: str = "cuda", small: dict | None = None) -> dict:
    """Phase 22: the training measurement tools of sam_road_tpu_torch/tools/,
    each printing its JSON line (profile_training_feed, experiment_train_memory,
    sweep_train_throughput, experiment_fused_train at the flagship config,
    profile_topo on a 2048 px tile, verify_real_ckpt --oracle on a SAM-format
    vit_b fake at 512 px, every stage within 1e-3), then the training
    configurations never run on the card: configs/toponet_vith_256.yaml
    through experiment_fused_train (K5's (112, 80) instance in the eager
    arm, K6 at head_dim 80 in the fused one), configs/toponet_vitl_256.yaml
    through run_training, and configs/toponet_vitb_1024.yaml with and
    without REMAT_ENCODER through experiment_train_memory, each with its
    peak memory. `small` (overrides, a vit_t geometry) rehearses it on the
    CPU. Returns the launches by run."""
    from sam_road_tpu_torch.config import load_config, read_flat_yaml
    from sam_road_tpu_torch.tools import (experiment_fused_train, experiment_train_memory,
                                          profile_topo, profile_training_feed,
                                          sweep_train_throughput, verify_real_ckpt)

    over = dict(small or {})
    tiny = bool(small)
    launches = {}

    t = time.time()
    feed = profile_training_feed.main(dev, overrides=over, **FEED_RUN,
                                      **(dict(image_size=256, spacing=64, batch=2) if tiny
                                         else {}))
    positive_times("profile_training_feed", [v for k, v in feed.items()
                                             if k.startswith(("device_step", "steps_per_s"))])
    print(f"profile_training_feed took {time.time() - t:.1f} s", flush=True)

    t = time.time()
    depth, _ = encoder_shape(load_config(overrides={**experiment_train_memory.GEOMETRY, **over}))
    mem = experiment_train_memory.main(2 if tiny else 16, dev, overrides=over)
    check_memory_rows("experiment_train_memory", mem, depth, 1, dev)
    print(f"experiment_train_memory took {time.time() - t:.1f} s", flush=True)

    t = time.time()
    sweep = sweep_train_throughput.main(TRAIN_SWEEP_STEPS, dev, overrides=over,
                                        **(dict(batches=(2, 4)) if tiny else {}))
    for row in sweep["rows"]:
        want = {"fused_attention": depth * TRAIN_SWEEP_STEPS * (2 if row["remat"] else 1)}
        if not row["loss_finite"] or (dev == "cuda" and row["launches"] != want):
            raise SystemExit(f"sweep_train_throughput {row['config']}: loss not finite or "
                             f"launches {row['launches']}, expected {want}")
    positive_times("sweep_train_throughput", [r["s_per_step"] for r in sweep["rows"]])
    print(f"sweep_train_throughput took {time.time() - t:.1f} s", flush=True)

    t = time.time()
    ab = experiment_fused_train.main(device=dev, overrides=over, **FUSED_AB,
                                     **(dict(batch=2) if tiny else {}))
    check_fused_ab("experiment_fused_train", ab, load_config(FLAGSHIP, overrides=over), dev)
    print(f"experiment_fused_train took {time.time() - t:.1f} s", flush=True)

    t = time.time()
    topo = profile_topo.main(512 if tiny else 2048)
    if not (0 < topo["f1"] <= 1 and topo["gt_nodes"] and topo["prop_nodes"]):
        raise SystemExit(f"profile_topo: {topo}")
    print(f"profile_topo took {time.time() - t:.1f} s", flush=True)

    t = time.time()
    with tempfile.TemporaryDirectory(prefix="samroad_ckpt_") as tmp:
        path = os.path.join(tmp, "sam_vit_b_fake.pth")
        write_sam_checkpoint(path, seed, sam_version="vit_t" if tiny else "vit_b")
        ckpt = (verify_real_ckpt.run(path, "vit_t", 64, oracle=True, device=dev) if tiny
                else verify_real_ckpt.main([path, "--oracle", "--device", dev]))
    print(json.dumps(ckpt), flush=True)
    want = {"fused_attention_f32": 12}  # every block of vit_b through K5's fp32 kernel
    if not ckpt["worst"] < verify_real_ckpt.PASS_TOL or (dev == "cuda"
                                                         and ckpt["launches"] != want):
        raise SystemExit(f"verify_real_ckpt: worst stage diff {ckpt['worst']}, launches "
                         f"{ckpt['launches']} (expected {want})")
    launches["verify_real_ckpt"] = ckpt["launches"]
    print(f"verify_real_ckpt took {time.time() - t:.1f} s", flush=True)

    t = time.time()
    vith = experiment_fused_train.main(batch=None, device=dev, base=VITH_CONFIG,
                                       overrides=over, **VITH_CONFIG_AB)
    check_fused_ab(f"{VITH_CONFIG} training", vith, load_config(VITH_CONFIG, overrides=over),
                   dev)
    launches["vith_eager"], launches["vith_fused"] = (vith["eager"]["launches"],
                                                      vith["fused"]["launches"])
    del vith
    print(f"{VITH_CONFIG} training took {time.time() - t:.1f} s", flush=True)

    t = time.time()
    vitl = {**read_flat_yaml(VITL_CONFIG), **over}
    launches["vitl"] = run_training(seed, dev, overrides=vitl,
                                    per_forward=encoder_shape(load_config(overrides=vitl))[0])
    print(f"{VITL_CONFIG} training took {time.time() - t:.1f} s", flush=True)

    t = time.time()
    cfg = load_config(VITB_1024_CONFIG, overrides=over)
    mem = experiment_train_memory.main(None, dev, base=VITB_1024_CONFIG, overrides=over,
                                       flash=(True,), remat=(True, False),
                                       steps=MEMORY_1024_STEPS)
    rows = check_memory_rows(f"{VITB_1024_CONFIG} training", mem, encoder_shape(cfg)[0],
                             MEMORY_1024_STEPS, dev)
    if dev == "cuda" and not rows["flash1_remat1"]["peak_mb"] < rows["flash1_remat0"]["peak_mb"]:
        raise SystemExit(f"{VITB_1024_CONFIG}: REMAT_ENCODER did not lower peak memory")
    launches.update({f"vitb_1024_{k}": row["launches"] for k, row in rows.items()})
    print(f"{VITB_1024_CONFIG} training took {time.time() - t:.1f} s", flush=True)
    return launches


def mesh_devices(n: int, dev: str = "cuda") -> list:
    """n distinct cards where that many are visible, else `dev` n times."""
    import torch

    if dev == "cuda" and torch.cuda.device_count() >= n:
        return [f"cuda:{i}" for i in range(n)]
    return [dev] * n


def reset_peaks(devices) -> None:
    import torch

    for d in dict.fromkeys(devices):
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)


def peaks_gib(devices) -> dict:
    """Peak memory allocated on each distinct device of `devices`, GiB."""
    import torch

    return {str(d): (torch.cuda.max_memory_allocated(d) / 2 ** 30
                     if torch.device(d).type == "cuda" else 0.0)
            for d in dict.fromkeys(devices)}


def calibrated_single(cfg, model, img, dev: str):
    """The single-device engine on `img` after the bench tool's calibration (a
    warm run at thresholds 1.0, then the masks' 0.99 / 0.92 quantiles set
    on `cfg`, which the mesh engines share); returns the engine and its
    timed result."""
    from sam_road_tpu_torch.inference.engine import TiledInferenceEngine

    engine = TiledInferenceEngine(cfg, model, dev)
    calibrate(engine, img)
    return engine, engine.infer_one_img(img)


def edge_set(nodes, edges) -> set:
    return {tuple(sorted((tuple(map(int, nodes[a])), tuple(map(int, nodes[b])))))
            for a, b in edges}


def mask_gap(got, want) -> str:
    """The largest uint8 level difference and the differing pixels of the
    keypoint and road masks."""
    parts = []
    for name, a, b in (("keypoint", got[2], want[2]), ("road", got[3], want[3])):
        d = np.abs(a.astype(int) - b.astype(int))
        parts.append(f"{name} max {d.max()} levels, {int((d > 0).sum())} px differ, "
                     f"{int((d > 1).sum())} by more than 1")
    return "; ".join(parts)


def run_dp_region(seed: int, dev: str = "cuda", overrides: dict = BENCH, region: int = REGION,
                  n: int = DP_N, per_forward: dict = INFER_MODES["default"][1]):
    """Phase 20a: the bench workload (`overrides`, seeded weights, the
    rng(0) region) through the engine's DP banding over n shards (distinct
    cards where n are visible, else `dev` n times) against the
    single-device engine: masks bit-equal, vertices and edges equal, and
    exactly rounds x per_forward launches of each kernel on each shard.
    Prints both engines' phase times and every device's peak memory.
    Returns the launches of the DP run by kernel and by shard."""
    import collections

    from sam_road_tpu_torch.config import load_config
    from sam_road_tpu_torch.data.partitions import get_patch_info_one_img
    from sam_road_tpu_torch.inference.engine import TiledInferenceEngine, band_assignment
    from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random
    from sam_road_tpu_torch.ops import _build
    from sam_road_tpu_torch.parallel import make_mesh

    cfg = load_config(overrides=overrides)
    model = init_random(SAMRoad.from_config(cfg), seed)
    img = np.random.default_rng(0).integers(0, 255, size=(region, region, 3), dtype=np.uint8)
    single, want = calibrated_single(cfg, model, img, dev)
    print(f"single device: nodes {want[0].shape[0]} edges {want[1].shape[0]} timings "
          f"{single.last_timings}", flush=True)
    del single
    mesh = make_mesh(n, mesh_devices(n, dev))
    engine = TiledInferenceEngine(cfg, model, dev, mesh=mesh)
    engine.infer_one_img(img)  # warm
    b = cfg.INFER_BATCH_SIZE // n
    infos = get_patch_info_one_img(0, region, cfg.SAMPLE_MARGIN, cfg.PATCH_SIZE,
                                   cfg.INFER_PATCHES_PER_EDGE)
    per_dev, offs, band_h = band_assignment(infos, region, n, cfg.PATCH_SIZE)
    rounds = max(-(-len(g) // b) for g in per_dev)
    # each phase-1 batch is one shard's round, the shards in turn round by round
    per_shard = [collections.Counter() for _ in range(n)]
    batch_fn, calls = engine._phase1_batch, []

    def counted(*args):
        before = collections.Counter(_build.launches)
        out = batch_fn(*args)
        per_shard[len(calls) % n].update(collections.Counter(_build.launches) - before)
        calls.append(1)
        return out

    engine._phase1_batch = counted
    reset_peaks(mesh.devices)
    _build.reset_launches()
    got = engine.infer_one_img(img)
    launches = dict(_build.launches)
    peaks = peaks_gib(mesh.devices)
    del engine._phase1_batch
    dp_t = dict(engine.last_timings)
    engine.infer_one_img(img)
    print(f"DP over {n} shards {[str(d) for d in mesh.devices]}: {len(infos)} patches, "
          f"{b} a shard's round, {rounds} rounds, bands of {band_h} rows at {offs}; nodes "
          f"{got[0].shape[0]} edges {got[1].shape[0]}; timings {dp_t}, repeat "
          f"{engine.last_timings}; peak memory allocated GiB {peaks}", flush=True)
    print(f"DP launches {launches}; per shard {[dict(c) for c in per_shard]}", flush=True)
    print(f"DP against single device: {mask_gap(got, want)}", flush=True)
    same = (np.array_equal(got[2], want[2]) and np.array_equal(got[3], want[3])
            and np.array_equal(got[0], want[0])
            and edge_set(got[0], got[1]) == edge_set(want[0], want[1]))
    if not same:
        raise SystemExit("DP masks, vertices or edges differ from the single-device engine's")
    if launches != {k: v * n * rounds for k, v in per_forward.items()} or any(
            dict(c) != {k: v * rounds for k, v in per_forward.items()} for c in per_shard):
        raise SystemExit(f"DP launches {launches} / {per_shard}, expected {per_forward} x "
                         f"{rounds} rounds on each of {n} shards")
    print("DP: masks bit-equal, vertices and edges equal to the single-device engine's",
          flush=True)
    return dict(shards=n, rounds=rounds, batch=b, devices=[str(d) for d in mesh.devices],
                total=launches, per_shard=[dict(c) for c in per_shard])


def run_sp_region(seed: int, dev: str = "cuda", config: str = SP_CONFIG, region: int = REGION,
                  n: int = SP_N, overrides: dict | None = None):
    """Phase 20b: `config` (seeded weights) with SP_SHARDS n and 1: the SP
    encoder's features on the region's first batch against the fp32 eager
    encoder (cosine >= COS_MIN), then the region through each SP engine
    against the single-device engine (FUSED_ENCODER, K1-K4): the masks'
    level differences, the vertex-set difference and the times, printed."""
    import torch

    from sam_road_tpu_torch.config import Config, load_config, read_flat_yaml
    from sam_road_tpu_torch.data.partitions import get_patch_info_one_img
    from sam_road_tpu_torch.inference.engine import TiledInferenceEngine
    from sam_road_tpu_torch.models.sam_road import PIXEL_MEAN, PIXEL_STD, SAMRoad, init_random
    from sam_road_tpu_torch.parallel import make_mesh

    cfg = load_config(overrides={**read_flat_yaml(config), **(overrides or {})})
    model = init_random(SAMRoad.from_config(cfg), seed)
    img = np.random.default_rng(0).integers(0, 255, size=(region, region, 3), dtype=np.uint8)
    single, want = calibrated_single(cfg, model, img, dev)
    print(f"single device ({config}): nodes {want[0].shape[0]} edges {want[1].shape[0]} "
          f"timings {single.last_timings}", flush=True)
    del single
    p = cfg.PATCH_SIZE
    xy = [i[1] for i in get_patch_info_one_img(0, region, cfg.SAMPLE_MARGIN, p,
                                               cfg.INFER_PATCHES_PER_EDGE)]
    crops = np.stack([img[y:y + p, x:x + p] for x, y in xy[:cfg.INFER_BATCH_SIZE]])
    rgb = torch.from_numpy(crops).to(dev).float()
    enc = model.image_encoder
    with torch.no_grad():  # the fp32 eager reference, SP_ENCODER_CHUNK images a call
        xf = (rgb - torch.tensor(PIXEL_MEAN, device=dev)) / torch.tensor(PIXEL_STD, device=dev)
        enc.dtype = torch.float32
        for blk in enc.blocks:
            blk.attn.use_flash = False
        ref = torch.cat([enc(xf[i:i + SP_ENCODER_CHUNK]) for i in
                         range(0, xf.shape[0], SP_ENCODER_CHUNK)]).float()
        enc.dtype = model.dtype
        for blk in enc.blocks:
            blk.attn.use_flash = cfg.FLASH_ATTENTION
    del xf
    out = {}
    for shards in (n, 1):
        mesh = make_mesh(shards, mesh_devices(shards, dev))
        engine = TiledInferenceEngine(Config({**cfg, "SP_SHARDS": shards}), model, dev, mesh=mesh)
        with torch.no_grad():
            feats = engine.encoder(enc, model.normalize(rgb)).float()
        cos = torch.nn.functional.cosine_similarity(feats.flatten(), ref.flatten(), dim=0).item()
        ok = bool(torch.isfinite(feats).all()) and cos >= COS_MIN
        print(f"SP_SHARDS {shards} encoder ({tuple(feats.shape)}, bf16) vs eager fp32: cosine "
              f"{cos:.6f} max_abs {(feats - ref).abs().max().item():.3e} (min {COS_MIN}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"the SP_SHARDS {shards} encoder disagrees with the eager encoder")
        del feats
        reset_peaks(mesh.devices)
        t = time.time()
        got = engine.infer_one_img(img)
        wall = time.time() - t
        s0 = {tuple(map(int, v)) for v in want[0]}
        s1 = {tuple(map(int, v)) for v in got[0]}
        print(f"SP_SHARDS {shards} region over {[str(d) for d in mesh.devices]}: {wall:.3f} s, "
              f"timings {engine.last_timings}; nodes {got[0].shape[0]} edges "
              f"{got[1].shape[0]}; vertex-set difference {len(s0 ^ s1)} of {len(s0)}; "
              f"{mask_gap(got, want)}; peak memory allocated GiB {peaks_gib(mesh.devices)}",
              flush=True)
        if got[0].shape[0] == 0 or got[1].shape[0] == 0:
            raise SystemExit(f"SP_SHARDS {shards}: an empty graph")
        out[shards] = dict(cosine=cos, seconds=wall, vertex_gap=len(s0 ^ s1))
        del engine
    return out


def ddp_rank(rank: int, world: int, backend: str, port: int, work: str, seed: int,
             geometry: dict, devices: list):
    """Phase 20c, one spawned rank: joins the process group, trains the
    seeded model deterministic on its rows of work/batches.pkl
    (parallel.shard_batch), and writes its logs, launches and peak memory
    to work/<backend>_rank<rank>.json."""
    import torch
    import torch.distributed as dist

    from sam_road_tpu_torch.config import load_config
    from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random
    from sam_road_tpu_torch.ops import _build
    from sam_road_tpu_torch.parallel import shard_batch
    from sam_road_tpu_torch.training.harness import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        with open(os.path.join(work, "batches.pkl"), "rb") as f:
            batches = pickle.load(f)
        cfg = load_config(overrides=geometry)
        trainer = Trainer(cfg, init_random(SAMRoad.from_config(cfg), seed), work, len(batches),
                          device=dev, log_every=1, deterministic=True)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launches()
        logs = trainer.train_epoch([shard_batch(b, rank, world) for b in batches], epoch=0)
        out = dict(logs=logs, launches=dict(_build.launches),
                   peak=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work, f"{backend}_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ddp(seed: int, dev: str = "cuda", geometry: dict = TRAIN, steps: int = DDP_STEPS,
            per_forward: int = 12):
    """Phase 20c: `steps` deterministic training steps of the seeded model
    at `geometry` in one process, then under DistributedDataParallel: 2
    gloo ranks on `dev` with half the rows each, and (on the card) NCCL
    over every visible card. Batch 0's halves hold different numbers of
    valid pairs. Each rank's loss and grad_norm must stay within
    DDP_LOSS_RTOL / DDP_GRAD_RTOL of one process's at every step, with the
    same skipped flags, and launch K5 per_forward times a step. Returns
    each run's launches by rank."""
    import torch
    import torch.multiprocessing as mp

    from sam_road_tpu_torch.config import load_config
    from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random
    from sam_road_tpu_torch.training.harness import Trainer

    work = tempfile.mkdtemp(prefix="samroad_ddp_")
    try:
        batches = train_batches(steps, seed, geometry)
        b0, half = batches[0], geometry["BATCH_SIZE"] // 2
        keep = np.random.default_rng(seed + 1).random(b0["valid"][half:].shape) < 0.35
        keep[:, 0, 0] = True
        b0["valid"][half:] &= keep
        b0["connected"] &= b0["valid"]
        counts = b0["valid"].reshape(2, -1).sum(axis=1).tolist()
        with open(os.path.join(work, "batches.pkl"), "wb") as f:
            pickle.dump(batches, f)
        cfg = load_config(overrides=geometry)
        trainer = Trainer(cfg, init_random(SAMRoad.from_config(cfg), seed), work, steps,
                          device=dev, log_every=1, deterministic=True)
        want = trainer.train_epoch(batches, epoch=0)
        del trainer
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()
        print(f"one process, {geometry['BATCH_SIZE']} rows a step (batch 0's halves hold "
              f"{counts} valid pairs): losses {[round(w['loss'], 6) for w in want]} grad_norm "
              f"{[round(w['grad_norm'], 6) for w in want]}; seconds per step after the first "
              f"{statistics.mean(w['seconds'] for w in want[1:]):.4f}", flush=True)
        runs = {"gloo": ["cuda:0" if dev == "cuda" else dev] * 2}
        if dev == "cuda":
            runs["nccl"] = [f"cuda:{i}" for i in range(max(1, torch.cuda.device_count()))]
        out = {}
        for backend, devices in runs.items():
            world = len(devices)
            t = time.time()
            mp.start_processes(ddp_rank, args=(world, backend, free_port(), work, seed, geometry,
                                               devices), nprocs=world, start_method="spawn")
            wall = time.time() - t
            ranks = []
            for r in range(world):
                with open(os.path.join(work, f"{backend}_rank{r}.json")) as f:
                    ranks.append(json.load(f))
            worst_loss = worst_norm = 0.0
            for rank in ranks:
                if len(rank["logs"]) != steps:
                    raise SystemExit(f"{backend}: a rank logged {len(rank['logs'])} steps")
                for got, ref in zip(rank["logs"], want):
                    worst_loss = max(worst_loss, abs(got["loss"] - ref["loss"]) / abs(ref["loss"]))
                    worst_norm = max(worst_norm, abs(got["grad_norm"] - ref["grad_norm"])
                                     / abs(ref["grad_norm"]))
                    if got["skipped"] != ref["skipped"]:
                        raise SystemExit(f"{backend}: a step's skipped flag differs")
            steady = [log["seconds"] for log in ranks[0]["logs"][1:]]
            launches = [rank["launches"] for rank in ranks]
            print(f"DDP {backend}, {world} ranks on {devices} x {geometry['BATCH_SIZE'] // world} "
                  f"rows: losses {[round(log['loss'], 6) for log in ranks[0]['logs']]} grad_norm "
                  f"{[round(log['grad_norm'], 6) for log in ranks[0]['logs']]}; largest relative "
                  f"gap to one process: loss {worst_loss:.3e} (max {DDP_LOSS_RTOL}) grad_norm "
                  f"{worst_norm:.3e} (max {DDP_GRAD_RTOL}); seconds per step after the first "
                  f"{statistics.mean(steady):.4f} ({', '.join(f'{x:.4f}' for x in steady)}); peak "
                  f"memory allocated GiB {[round(rank['peak'] / 2 ** 30, 3) for rank in ranks]}; "
                  f"launches by rank {launches}; run with start-up {wall:.1f} s", flush=True)
            if worst_loss > DDP_LOSS_RTOL or worst_norm > DDP_GRAD_RTOL:
                raise SystemExit(f"DDP {backend}: losses or grad_norm differ from one process's")
            if dev == "cuda" and any(l != {"fused_attention": per_forward * steps}
                                     for l in launches):
                raise SystemExit(f"DDP {backend}: launches {launches}, expected "
                                 f"{per_forward * steps} of fused_attention on each rank")
            out[f"{backend}_{world}x{geometry['BATCH_SIZE'] // world}"] = launches
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_multi_cli(work: str, dev: str = "cuda"):
    """Phase 20d, over phase 10's files in `work` (its calibrated config,
    SAM-format checkpoint and tiles; save/default its single-device masks)
    and phase 9's dataset: cli.infer on the first tile with SP_SHARDS 1 and,
    where 2 or more cards are visible, with DP_SHARDS = every card (masks
    bit-equal); cli.infer with more shards than cards raises; cli.train
    --dev_run under torch.distributed.run, one rank per card."""
    import torch

    from sam_road_tpu_torch.cli import infer
    from sam_road_tpu_torch.config import read_flat_yaml, write_flat_yaml
    from sam_road_tpu_torch.data.partitions import cityscale_data_partition
    from sam_road_tpu_torch.data.png import read_png
    from sam_road_tpu_torch.ops import _build

    tile = cityscale_data_partition()[2][0]
    values = read_flat_yaml(os.path.join(work, "infer.yaml"))
    pth = os.path.join(work, "sam_vit_b_seeded.pth")
    data = os.path.join(work, "infer_data")
    cards = torch.cuda.device_count() if dev == "cuda" else 0

    def masks(run):
        return [read_png(os.path.join(work, "save", run, "mask", f"{tile}_{k}.png"))
                for k in ("itsc", "road")]

    def cli_infer(name, **keys):
        path = os.path.join(work, f"{name}.yaml")
        write_flat_yaml(path, {**values, **keys})
        return infer.main(["--config", path, "--checkpoint", pth, "--data_root", data,
                           "--output_dir", name, "--max_tiles", "1", "--device", dev])

    want = masks("default")
    runs = {"sp1": dict(SP_SHARDS=1)}
    if cards >= 2:
        runs["dp"] = dict(DP_SHARDS=cards)
    cwd = os.getcwd()
    os.chdir(work)  # the CLI writes ./save/<output_dir>
    try:
        for name, keys in runs.items():
            _build.reset_launches()
            t = time.time()
            cli_infer(name, **keys)
            wall = time.time() - t
            got = masks(name)
            gaps = [np.abs(a.astype(int) - b.astype(int)) for a, b in zip(got, want)]
            print(f"cli.infer {keys}: tile {tile} in {wall:.1f} s with loading; against the "
                  f"single-device run: itsc max {gaps[0].max()} levels ({int((gaps[0] > 0).sum())}"
                  f" px differ), road max {gaps[1].max()} ({int((gaps[1] > 0).sum())} px); "
                  f"launches {dict(_build.launches)}", flush=True)
            if name == "dp" and any(g.any() for g in gaps):
                raise SystemExit("cli.infer DP masks differ from the single-device run's")
            if name == "sp1" and any(g.max() > SP_CLI_MAX_LEVELS for g in gaps):
                raise SystemExit(f"cli.infer SP_SHARDS 1 masks differ from the single-device "
                                 f"run's by more than {SP_CLI_MAX_LEVELS} levels")
        too_many = max(cards, 1) + 1
        try:
            cli_infer("too_many", DP_SHARDS=too_many)
        except RuntimeError as e:
            print(f"cli.infer DP_SHARDS {too_many} raises: {e}", flush=True)
        else:
            raise SystemExit(f"cli.infer ran with DP_SHARDS {too_many} on {cards} card(s)")
    finally:
        os.chdir(cwd)

    ranks = max(cards, 1)
    out = os.path.join(work, "ddp_train")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={ranks}", "-m", "sam_road_tpu_torch.cli.train", "--config",
           os.path.join(work, "eager.yaml"), "--dev_run", "--steps_per_epoch", "2",
           "--data_root", os.path.join(work, "data"), "--output_dir", out, "--device", dev]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t = time.time()
    proc = subprocess.run(cmd, cwd=work, env=env, capture_output=True, text=True, timeout=600)
    lines = [l for l in proc.stdout.splitlines() if l.startswith(("epoch", "saved"))]
    print(f"cli.train under torch.distributed.run, {ranks} rank(s): rc {proc.returncode} in "
          f"{time.time() - t:.1f} s", flush=True)
    print("\n".join(lines), flush=True)
    if proc.returncode or not os.path.exists(os.path.join(out, "ckpt_epoch_0.pt")):
        print(proc.stderr[-4000:], flush=True)
        raise SystemExit("cli.train under torch.distributed.run failed")


E2E_APLS_MIN = 0.80  # the example's floors over the fixture's test tile, set below the
E2E_TOPO_F1_MIN = 0.90  # JAX example's record (APLS 0.922-0.971, TOPO F1 0.971-0.994)
E2E_INSTANCE = (64, 32)  # vit_t's windows in K5: D 32 + 14 + 14 = 60 -> 64, dv 32
PROBE_ROUNDS = 2


def run_e2e_example(dev: str = "cuda", epochs: int = 4, steps_per_epoch: int = 150) -> dict:
    """Phase 24: sam_road_tpu_torch/examples/end_to_end_synthetic.py at its
    own settings (vit_t, 80 px patches, batch 16, bf16, 4 epochs of 150
    steps; cli.train, cli.test, cli.infer, cli.evaluate) in a temporary
    directory. The last epoch's mean loss must be below the first's, APLS
    and TOPO F1 over the fixture's test tile at least E2E_APLS_MIN and
    E2E_TOPO_F1_MIN, and K5 must run during training, every call at
    E2E_INSTANCE (where the eager encoder's windowed block takes it).
    The instances are those that ops/attention.py::folded_instance, the
    Python table, picks at each K5 call; the C entries report none. Their
    dispatch chains apply the same rule, and only (64, 32) takes dv 32, so
    a call at dv 32 that returned success launched that instance.
    Returns the example's report with K5's instances by stage."""
    from collections import Counter

    from sam_road_tpu_torch.examples import end_to_end_synthetic
    from sam_road_tpu_torch.ops import _build, attention

    picked = Counter()
    instance = attention.folded_instance

    def counted(D, dv):
        out = instance(D, dv)
        picked[out] += 1
        return out

    work = tempfile.mkdtemp(prefix="samroad_e2e_")
    _build.reset_launches()
    attention.folded_instance = counted
    try:
        report = end_to_end_synthetic.main(work, epochs, steps_per_epoch, dev)
    finally:
        attention.folded_instance = instance
        shutil.rmtree(work, ignore_errors=True)
    art = report["artifact"]
    apls = float(art["apls"]["final_APLS"])
    f1 = float(np.mean(art["topo"]["f1"]))
    losses = report["epoch_loss"]
    k5 = report["launches"]["train"].get("fused_attention", 0)
    print(f"example: mean loss by epoch {losses}, step {report['step_seconds']:.4f} s "
          f"(median; the loader's wait {report['wait_seconds']:.4f} s of it), stages "
          f"{report['seconds']}, APLS {apls:.4f}, TOPO F1 {f1:.4f}, "
          f"launches {report['launches']}, K5 instances {dict(picked)} | {gpu_line()}",
          flush=True)
    if not (len(losses) == epochs and losses[-1] < losses[0]):
        raise SystemExit(f"the example's training loss did not fall: {losses}")
    if not (apls >= E2E_APLS_MIN and f1 >= E2E_TOPO_F1_MIN):
        raise SystemExit(f"the example scored APLS {apls} / TOPO F1 {f1}, below its floors "
                         f"{E2E_APLS_MIN} / {E2E_TOPO_F1_MIN}")
    if k5 < epochs * steps_per_epoch or set(picked) != {E2E_INSTANCE}:
        raise SystemExit(f"K5 did not carry the example's training at {E2E_INSTANCE}: "
                         f"{k5} launches, instances {dict(picked)}")
    report["k5_instances"] = {str(k): v for k, v in picked.items()}
    return report


def nondecreasing(values) -> bool:
    return all(a <= b for a, b in zip(values, values[1:]))


def run_stream_probes(dev: str = "cuda", rounds: int = PROBE_ROUNDS, **small) -> dict:
    """Phase 25: tools/probe_stream_sched.py and probe_band_overhead.py at
    the bench geometry, `rounds` rounds each (`small`: model, overrides,
    region, for a rehearsal). Every instrumented run bit-equal to its plain
    run, every field present, band_disp, chunk_ready and fetch_done
    non-decreasing; the bands' masks bit-equal to the whole path's."""
    from sam_road_tpu_torch.tools import probe_band_overhead, probe_stream_sched

    from sam_road_tpu_torch.ops import _build

    fields = ("slab_disp", "slab_ready", "band_disp", "chunk_ready", "fetch_done",
              "seg_slice_s", "slab_wait_s", "p1_wall", "engine_timings", "total")
    _build.reset_launches()
    t = time.time()
    sched = probe_stream_sched.main(dev, rounds=rounds, **small)
    print(f"probe_stream_sched took {time.time() - t:.1f} s", flush=True)
    for row in sched:
        rec = row["instr"]
        if not row["same_outputs"] or set(rec) != set(fields):
            raise SystemExit(f"probe_stream_sched round {row['round']}: outputs equal "
                             f"{row['same_outputs']}, fields {sorted(rec)}")
        k = len(row["bands"])
        if any(len(rec[key]) != k for key in fields[:7]) or not all(
                nondecreasing(rec[key]) for key in ("band_disp", "chunk_ready", "fetch_done")):
            raise SystemExit(f"probe_stream_sched round {row['round']}: a timeline is "
                             f"short or out of order: {rec}")
    t = time.time()
    overhead = probe_band_overhead.main(dev, rounds=rounds, **small)
    print(f"probe_band_overhead took {time.time() - t:.1f} s | {gpu_line()}", flush=True)
    if not all(row["masks_equal"] for row in overhead):
        raise SystemExit("the bands' masks differ from the whole path's")
    launches = dict(_build.launches)
    print(f"the probes' launches {launches}", flush=True)
    if dev == "cuda" and not launches:
        raise SystemExit("the probes launched no kernel")
    return {"stream_sched": sched, "band_overhead": overhead, "launches": launches}


def check_full_width_loss(dev: str = "cuda") -> dict:
    """Phase 26: tools/full_width_loss.py: the fp32 training step's losses
    and gradient norm at ViT-B 512 px on the JAX package's committed
    numbers, within its TOLERANCE (1e-5 relative), the encoder through K5's
    fp32 kernel (12 launches: one a block), TF32 off. Then the control: the
    same step with TF32 on for cuBLAS and cuDNN must miss TOLERANCE, or the
    check could not see such a leak."""
    from sam_road_tpu_torch.tools import full_width_loss

    res = full_width_loss.main(dev)
    k5 = res["launches"].get("fused_attention_f32", 0)
    control = full_width_loss.main(dev, tf32=True)
    print(f"full-width loss: rel_err {res['rel_err']} (tol {res['tolerance']}), "
          f"fused_attention_f32 launches {k5}, {res['seconds']:.2f} s; with TF32 on "
          f"(the control) rel_err {control['rel_err']} | {gpu_line()}", flush=True)
    if not res["ok"] or (dev == "cuda" and k5 != 12):
        raise SystemExit(f"the full-width fp32 step misses JAX's numbers: {res}")
    if dev == "cuda" and control["ok"]:
        raise SystemExit(f"the full-width check does not see TF32 in cuBLAS: {control}")
    res["tf32_control_rel_err"] = control["rel_err"]
    return res


def main():
    phase("1 device")
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: this smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = gpu_line()
    print(f"gpu {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("2 build")
    from sam_road_tpu_torch.graph.nms import _lib as nms_lib
    from sam_road_tpu_torch.inference.pairs import _lib as pairs_lib
    from sam_road_tpu_torch.metrics._native import load_topo_native
    from sam_road_tpu_torch.metrics.apls_native import ensure_apls_binary
    from sam_road_tpu_torch.ops import _build
    from sam_road_tpu_torch.utils.viz import _lib as draw_lib

    from concurrent.futures import ThreadPoolExecutor

    def build_host():  # the host's compilers run beside nvcc's
        t = time.time()
        nms_lib(), pairs_lib(), load_topo_native(), ensure_apls_binary(), draw_lib()
        return time.time() - t

    t = time.time()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(build_host)
        lib = _build.kernels()
        print(f"built CUDA kernels in {time.time() - t:.1f} s", flush=True)
        print(f"built host native libs, the rasteriser and the APLS scorer in "
              f"{host.result():.1f} s, beside the CUDA build ({time.time() - t:.1f} s both)",
              flush=True)
    print_ptxas(lib._name + ".log", ("gemm_kernel", "ln_stats_kernel", "relpos_attention_kernel",
                                      "folded_attention_f32_kernel"))

    phase("3 kernels vs plain at the bench shapes (B=32)")
    results = check_kernels(32)

    phase("4 fused encoder vs eager encoder")
    check_encoder(SEED)

    phase("5 engine on the bench workload: the bench tool")
    launches = run_bench()

    phase("6 K5 fused_attention vs plain, forward and gradients: bf16, then fp32")
    flash = check_flash_attention()
    window = flash["window 14x14"]  # 8 of the 12 launches of a forward pass
    flash32 = check_flash_attention(dtype=torch.float32)
    results["fused_attention"] = dict(
        window, max_abs_err=max(r["max_abs_err"] for r in flash.values()), shapes=flash,
        fp32=dict(flash32["window 14x14"], source="sam_road_tpu_torch/csrc/"
                  "folded_attention_f32.cu", tol=TOL_F32, shapes=flash32,
                  max_abs_err=max(r["max_abs_err"] for r in flash32.values())))

    phase(f"7 training: {TRAIN_STEPS} steps and validation at ViT-B 512 px, batch 16, bf16")
    launches.update(run_training(SEED))

    phase(f"8 engine on a {EAGER_REGION} px region, FUSED_ENCODER off (K5)")
    run_engine(SEED, {**BENCH, "FUSED_ENCODER": False}, EAGER_REGION, {"fused_attention": 12})

    work = tempfile.mkdtemp(prefix="samroad_cli_")  # phase 9's dataset, kept for phase 10
    try:
        phase("9 training CLI with FUSED_ENCODER_TRAIN (K6) at ViT-B 512 px, batch 16, bf16")
        k6 = check_k6()
        check_train_encoder(SEED)
        k6_launches = run_training_cli(SEED, work)

        phase("10 PAD_FREE / WIN_* (K7, K8, K10), the inference and calibration CLIs")
        grid = check_grid_kernels(32)
        check_encoder_modes()
        infer_runs = run_infer_cli(SEED, work)
        run_test_cli(work)

        phase("16 the evaluation CLI over cli.infer's graphs")
        run_evaluate_cli(work)

        phase(f"17 LoRA + SAM decoder ({LORA_CONFIG}): the model, a region, training, "
              "and the training, calibration and inference CLIs")
        t = time.time()
        lora_k5 = check_flash_attention(cases=LORA_FLASH_CASES)
        lora_launches = run_lora(SEED)
        lora_launches.update(run_lora_cli(SEED, work))
        print(f"phase 17 took {time.time() - t:.1f} s", flush=True)

        phase(f"20 several shards: DP banding over the bench workload, SP ({SP_CONFIG}), "
              "DDP training steps, and the inference and training CLIs")
        t = time.time()
        gc.collect()
        torch.cuda.empty_cache()
        dp = run_dp_region(SEED)
        gc.collect()
        torch.cuda.empty_cache()
        run_sp_region(SEED)
        gc.collect()
        torch.cuda.empty_cache()
        ddp = run_ddp(SEED)
        run_multi_cli(work)
        print(f"phase 20 took {time.time() - t:.1f} s", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    phase("18 vit_l at 256 px and ViT-B at 1024 px: a region through each config")
    t = time.time()
    config_launches = run_config_regions(SEED)
    print(f"phase 18 took {time.time() - t:.1f} s", flush=True)

    phase(f"19 labels to a trained model: cli.prepare (SpaceNet, Cityscale), cli.debug_labels, "
          f"cli.train / cli.infer ({SPACENET_CONFIG}), cli.triage")
    labels = run_labels_to_model(SEED)
    grid_launches = {**infer_runs["pad_free"]["launches"],
                     **infer_runs["pad_free_g4"]["launches"], **infer_runs["rolled"]["launches"]}

    phase("11 the tools: K9, K11, K12, K13, the kernel A/B and the windowed-block profiler")
    t = time.time()
    tool = check_tool_kernels()
    tool_launches = run_tools()
    print(f"phase 11 took {time.time() - t:.1f} s", flush=True)

    phase("12 vit_h (head_dim 80): K2, K3, K10-K13, the fused encoder and a region")
    t = time.time()
    from sam_road_tpu_torch.config import load_config
    from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random

    vith_cfg = vith_overrides()
    vith = check_vith_kernels(int(vith_cfg["INFER_BATCH_SIZE"]))
    vith_model = init_random(SAMRoad.from_config(load_config(overrides=vith_cfg)), SEED)
    check_vith_encoder(vith_model)
    vith_launches = run_engine(SEED, vith_cfg, REGION, VITH_PER_BATCH, model=vith_model)
    del vith_model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 12 took {time.time() - t:.1f} s", flush=True)

    phase("13 the tools' kernels T1-T4 and their three tools")
    t = time.time()
    t_rows = check_t_kernels()
    t_launches = run_t_tools()
    print(f"phase 13 took {time.time() - t:.1f} s", flush=True)

    phase("14 the tools' kernels T5-T8, experiment_block_variants and probe_mosaic")
    t = time.time()
    t_rows.update(check_t58_kernels())
    t_launches.update(run_t58_tools())
    print(f"phase 14 took {time.time() - t:.1f} s", flush=True)

    phase("15 the tools' kernels T9-T13, probe_nondiv_blocks and repro_aot_crash")
    t = time.time()
    t_rows.update(check_t913_kernels())
    t_launches.update(run_t913_tools())
    print(f"phase 15 took {time.time() - t:.1f} s", flush=True)

    phase("21 the inference measurement tools: phase-1, extraction / phase-2 and phase-2 "
          "profilers, the engine A/B, the batch sweep, the encoder profiler")
    t = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    run_profilers()
    print(f"phase 21 took {time.time() - t:.1f} s", flush=True)

    phase("23 the engine's pipeline modes on the bench region: streamed phase 1, banded "
          "upload, fetch waves, packed arguments, device aggregation, speculative phase 2, "
          "each paired against the whole-region path; infer_tiles")
    t = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    pipeline = run_pipeline_modes(SEED)
    print(f"phase 23 took {time.time() - t:.1f} s", flush=True)

    phase("22 the training measurement tools, and training at vit_h, vit_l and 1024 px")
    t = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = run_train_tools(SEED)
    results["fused_attention"]["fp32"]["launches"] = train_launches["verify_real_ckpt"][
        "fused_attention_f32"]
    print(f"phase 22 took {time.time() - t:.1f} s", flush=True)

    phase("24 the synthetic example end to end (sam_road_tpu_torch/examples/"
          "end_to_end_synthetic.py): vit_t trained 4 x 150 steps, calibrated, inferred, scored")
    t = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    e2e = run_e2e_example()
    print(f"phase 24 took {time.time() - t:.1f} s", flush=True)

    phase(f"25 the streamed-schedule probes at the bench geometry, {PROBE_ROUNDS} rounds each")
    t = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    probes = run_stream_probes()
    print(f"phase 25 took {time.time() - t:.1f} s", flush=True)

    phase("26 the fp32 training step at ViT-B 512 px against the JAX package's numbers")
    t = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    full_width = check_full_width_loss()
    results["fused_attention"]["fp32"]["full_width_loss_launches"] = full_width["launches"][
        "fused_attention_f32"]
    print(f"phase 26 took {time.time() - t:.1f} s", flush=True)

    kernels = []
    def vith_fields(name):  # phase 12's head_dim 80 reading and vit_h region launches,
        extra = {"head_dim_80": vith[name]} if name in vith else {}  # phase 17's, 18's, 19's
        if name in vith_launches:
            extra["vith_region_launches"] = vith_launches[name]
        if name == "fused_attention":
            extra["lora_launches"] = {k: v.get(name, 0) for k, v in lora_launches.items()}
            extra["lora_shapes"] = lora_k5
        for path, runs in config_launches.items():
            if name in runs:
                key = os.path.basename(path).removesuffix(".yaml")
                extra[f"{key}_region_launches"] = runs[name]
        spacenet = {run: labels[f"{run}_launches"][name] for run in ("train", "infer")
                    if name in labels[f"{run}_launches"]}
        if spacenet:  # phase 19's cli.train and cli.infer, each counted alone
            extra["spacenet_launches"] = spacenet
        if name == "fused_attention":
            extra["spacenet_shapes"] = labels["k5"]
            extra["phase22_train_launches"] = {
                run: n[name] for run, n in train_launches.items() if name in n}
            extra["ddp_launches"] = {run: [r.get(name, 0) for r in ranks]
                                     for run, ranks in ddp.items()}  # phase 20c, by rank
        if name in pipeline["launches"]:  # phase 23: the default config's streamed region
            extra["stream_region_launches"] = pipeline["launches"][name]
        if name in probes["launches"]:  # phase 25: both probes, every round and warm run
            extra["stream_probe_launches"] = probes["launches"][name]
        for stage, counts in e2e["launches"].items():  # phase 24, by the example's stage
            if name in counts:
                extra[f"e2e_{stage}_launches"] = counts[name]
        if name in dp["total"]:  # phase 20a: DP over the bench workload
            extra["dp_region_launches"] = dict(
                shards=dp["shards"], rounds=dp["rounds"], batch=dp["batch"],
                per_shard=[c[name] for c in dp["per_shard"]], total=dp["total"][name])
        rows = {case: row for case, row in labels["infer_rows"].items()
                if case.split("+")[0] == name}
        if rows:  # K1-K4 at phase 19's cli.infer shapes, by case
            extra["spacenet_16x16"] = rows
        return extra

    for name, (src, replaces) in KERNEL_META.items():
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=launches[name], **results[name], **vith_fields(name)))
    for name, (kernel, src, replaces) in K6_META.items():  # K6: forward and backward
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=k6_launches[name], forward_kernel=kernel, **k6[name],
                            vith_train_launches=train_launches["vith_fused"][name]))
    for name, (src, replaces) in K10_META.items():  # K7, K8, K10
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=grid_launches[name], **grid[name], **vith_fields(name)))
    for name, (src, replaces) in TOOL_META.items():  # K9, K11, K12, K13
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=tool_launches[name], **tool[name], **vith_fields(name)))
    # T1-T13: the first variant's reading, and each variant's under `variants`
    for name, (src, replaces) in {**T_META, **T58_META, **T913_META}.items():
        rows = {label: row for label, row in t_rows.items() if label.split()[0] == name}
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=t_launches[name], **next(iter(rows.values())),
                            variants=rows))
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
