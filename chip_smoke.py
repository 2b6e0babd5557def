"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels,
checks and times each against its plain PyTorch version at the bench
shapes, checks the fused encoder against the eager one, drives the engine
over the bench workload (a 2048 px region, ViT-B at 512 px, batch 32, bf16,
random weights from a seed), checks and times K5 (forward and gradients),
takes training steps at ViT-B 512 px, batch 16, bf16, runs a region
through the eager encoder (FUSED_ENCODER off), and drives the training CLI
over a generated Cityscale-format dataset with FUSED_ENCODER_TRAIN (K6:
K1-K4 under autograd), showing that each path ran through its kernels.

    python3 chip_smoke.py

The last line of a passing run is {"ok": true, "device": {...}}; any failure
exits nonzero without it. Needs CUDA; never falls back to the CPU.
"""

from __future__ import annotations

import gc
import glob
import json
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

TOL = 2e-2  # |kernel - plain_fp32| <= TOL * (1 + |plain_fp32|), bf16 kernels
COS_MIN = 0.999
BENCH = dict(
    DATASET="cityscale", SAM_VERSION="vit_b", PATCH_SIZE=512,
    INFER_BATCH_SIZE=32, INFER_PATCHES_PER_EDGE=16, SAMPLE_MARGIN=64,
    COMPUTE_DTYPE="bfloat16", TOPO_SAMPLE_NUM=512, FUSED_ENCODER=True,
)
REGION = 2048
SEED = 0  # random weights (torch.Generator) for phases 4, 5, 7 and 8
TRAIN = dict(  # configs/toponet_vitb_512_cityscale.yaml's training geometry
    DATASET="cityscale", SAM_VERSION="vit_b", PATCH_SIZE=512, BATCH_SIZE=16,
    COMPUTE_DTYPE="bfloat16", TOPO_SAMPLE_NUM=512, MAX_NEIGHBOR_QUERIES=16,
    FLASH_ATTENTION=True, FUSED_ENCODER_TRAIN=False,
)
TRAIN_STEPS = 4
EAGER_REGION = 1024  # phase 8: BENCH with FUSED_ENCODER off
KERNEL_META = {  # wrapper -> (CUDA source, the TPU kernel it replaces)
    "ln_dense": ("sam_road_tpu_torch/csrc/gemm.cu", "sam_road_tpu/ops/fused_ln.py:61"),
    "window_attention_rows_grid": ("sam_road_tpu_torch/csrc/window_attention.cu",
                                   "sam_road_tpu/ops/fused_block.py:308"),
    "attention_relpos_rows": ("sam_road_tpu_torch/csrc/relpos_attention.cu",
                              "sam_road_tpu/ops/attention.py:188"),
    "proj_ln_mlp_residual": ("sam_road_tpu_torch/csrc/gemm.cu", "sam_road_tpu/ops/fused_ln.py:188"),
    "fused_attention": ("sam_road_tpu_torch/csrc/flash_attention.cu",
                        "sam_road_tpu/ops/attention.py:265"),
}
# phase 9: the training CLI over the flagship config's keys plus these
FLAGSHIP = "configs/toponet_vitb_512_cityscale.yaml"
CLI = dict(IMAGE_SIZE=1024, FUSED_ENCODER_TRAIN=True, TRAIN_EPOCHS=1, DATA_WORKER_NUM=4,
           VAL_VIZ_COUNT=4)
CLI_STEPS = 8
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
K6_PER_FORWARD = {"ln_dense_d": 8, "ln_dense_bias_d": 4, "proj_ln_mlp_residual_d": 12,
                  "window_attention_rows_grid_d": 8, "attention_relpos_rows_d": 4,
                  "ln_dense": 12, "window_attention_rows_grid": 8, "attention_relpos_rows": 4,
                  "proj_ln_mlp_residual": 12}


def phase(name):
    print(f"== {name}", flush=True)


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


def check_kernels(B: int, dev: str = "cuda"):
    """Phase 3: each kernel against its plain version at the bench shapes."""
    import torch

    from sam_road_tpu_torch.ops import attention, fused_block, fused_ln

    gen = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    C, heads, hd, grid, win = 768, 12, 64, 32, 14
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
        ms = cuda_ms(lambda: kern(*args))
        plain_ms = cuda_ms(lambda: plain(*args))
        ok = finite and max_rel <= TOL
        print(f"kernel {name}: shape {tuple(got.shape)} max_abs_err {max_abs:.3e} "
              f"max_rel_err {max_rel:.3e} (tol {TOL}) kernel_ms {ms:.4f} "
              f"plain_bf16_ms {plain_ms:.4f} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"kernel {name} disagrees with its plain version")
        results[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)
        del got, ref, err
    return results


def flash_cases(dev: str = "cuda"):
    """K5's shapes on the main path, bf16, as [B, heads, N, D] with D = 64 +
    H + W: the ViT-B 512 px windows (16 images x 9 windows, 196 tokens), its
    global grid (16 images, 1024 tokens) and the 1024 px config's global grid
    (2 images, 4096 tokens). q is scaled and carries q.R columns; k carries
    the exact one-hot position columns, as models/vit.py::fold_rel_pos_qk
    builds them."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(3)
    bf = torch.bfloat16
    heads, hd = 12, 64
    for name, B, side in (("window 14x14", 16 * 9, 14), ("global 32x32", 16, 32),
                          ("global 64x64", 2, 64)):
        N = side * side
        q = torch.randn((B, heads, N, hd), generator=gen, device=dev) * hd ** -0.5
        qr = torch.randn((B, heads, N, 2 * side), generator=gen, device=dev) * 0.3
        k = torch.randn((B, heads, N, hd), generator=gen, device=dev)
        idx = torch.arange(N, device=dev)
        pos = torch.cat([F.one_hot(idx // side, side), F.one_hot(idx % side, side)], dim=1)
        q = torch.cat([q, qr], dim=-1).to(bf)
        k = torch.cat([k, pos.float().expand(B, heads, N, 2 * side)], dim=-1).to(bf)
        v = torch.randn((B, heads, N, hd), generator=gen, device=dev).to(bf)
        g = torch.randn((B, heads, N, hd), generator=gen, device=dev).to(bf)
        yield name, q, k, v, g


def check_flash_attention(dev: str = "cuda"):
    """Phase 6: K5 against its plain version at the main path's shapes:
    the forward, and the autograd.Function's gradients against autograd
    through the plain version in fp32 on the same bf16 inputs."""
    import torch

    from sam_road_tpu_torch.ops import attention

    shapes = {}
    for name, q, k, v, g in flash_cases(dev):
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
        ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
        attention.fused_attention_plain(*ref_leaves).backward(g.float())
        bwd_rel = max(((a.grad.float() - b.grad).abs() / (1 + b.grad.abs())).max().item()
                      for a, b in zip(leaves, ref_leaves))
        finite = finite and all(bool(torch.isfinite(t.grad.float()).all()) for t in leaves)
        del leaves, ref_leaves
        with torch.no_grad():
            ms = cuda_ms(lambda: attention.fused_attention(q, k, v))
            plain_ms = cuda_ms(lambda: attention.fused_attention_plain(q, k, v))
        ok = finite and fwd_rel <= TOL and bwd_rel <= TOL
        print(f"kernel fused_attention {name}: q {tuple(q.shape)} v {tuple(v.shape)} "
              f"max_abs_err {max_abs:.3e} max_rel_err {fwd_rel:.3e} grad_max_rel_err "
              f"{bwd_rel:.3e} (tol {TOL}) kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"fused_attention disagrees with its plain version at {name}")
        shapes[name] = dict(max_abs_err=max_abs, grad_max_rel_err=bwd_rel, ms=ms,
                            plain_ms=plain_ms)
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


def run_engine(seed: int, overrides: dict, region: int, per_batch: dict, dev: str = "cuda"):
    """Phases 5 and 8: a region through the engine; returns the launches of
    the timed run, which must be `per_batch` launches of each kernel per
    batch."""
    from sam_road_tpu_torch.config import load_config
    from sam_road_tpu_torch.data.partitions import get_patch_info_one_img
    from sam_road_tpu_torch.inference.engine import TiledInferenceEngine
    from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random
    from sam_road_tpu_torch.ops import _build

    cfg = load_config(overrides=overrides)
    model = init_random(SAMRoad.from_config(cfg), seed)
    img = np.random.default_rng(0).integers(0, 255, size=(region, region, 3), dtype=np.uint8)
    engine = TiledInferenceEngine(cfg, model, dev)
    # Warm run with thresholds above 1 (no vertices): at the default
    # thresholds random weights put millions of pixels above threshold, and
    # the shared NMS treats every uint8 score > 1.0 as immune, so extraction
    # alone took ~171 s on the card's host. The masks do not depend on the
    # thresholds, so the calibration below is bench.py's.
    engine.config.ITSC_THRESHOLD = engine.config.ROAD_THRESHOLD = 1.0
    t = time.time()
    _, _, kp, road = engine.infer_one_img(img)  # warm run
    print(f"engine warm run {time.time() - t:.3f} s {engine.last_timings}", flush=True)
    engine.config.ITSC_THRESHOLD = float(np.quantile(kp / 255.0, 0.99))
    engine.config.ROAD_THRESHOLD = float(np.quantile(road / 255.0, 0.92))
    _build.reset_launches()
    nodes, edges, kp, road = engine.infer_one_img(img)
    launches = dict(_build.launches)
    print(f"engine timed run: nodes {nodes.shape[0]} edges {edges.shape[0]} "
          f"masks {kp.shape} {road.shape} timings {engine.last_timings}", flush=True)
    print(f"engine launches {launches}", flush=True)
    for _ in range(2):
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
    import torch

    crop = torch.from_numpy(img[m:m + p, m:m + p]).to(dev)[None].float()
    with torch.no_grad():
        scores, emb = engine.model.infer_masks_and_features(crop, engine.encoder)
    if not (torch.isfinite(scores).all() and torch.isfinite(emb.float()).all()):
        raise SystemExit("engine mask scores or features hold a NaN or inf")
    return launches


def train_batches(n: int, seed: int = 0):
    """n batches in collate_batch's format at the TRAIN geometry from
    np.random.default_rng(seed): uint8 rgb and masks, about 256 graph
    points per patch (padded to the 128 bucket), TOPO_SAMPLE_NUM x
    MAX_NEIGHBOR_QUERIES pairs within range, at least one valid per
    sample."""
    from sam_road_tpu_torch.data.dataset import collate_batch

    rng = np.random.default_rng(seed)
    p, S, K = TRAIN["PATCH_SIZE"], TRAIN["TOPO_SAMPLE_NUM"], TRAIN["MAX_NEIGHBOR_QUERIES"]
    batches = []
    for _ in range(n):
        samples = []
        for _ in range(TRAIN["BATCH_SIZE"]):
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


def run_training(seed: int, dev: str = "cuda"):
    """Phase 7: Trainer.train_epoch for TRAIN_STEPS steps and validate on
    one batch at the TRAIN geometry; returns the launches of that run."""
    import torch

    from sam_road_tpu_torch.config import load_config
    from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random
    from sam_road_tpu_torch.ops import _build
    from sam_road_tpu_torch.training.harness import Trainer

    cfg = load_config(overrides=TRAIN)
    batches = train_batches(TRAIN_STEPS, seed)
    model = init_random(SAMRoad.from_config(cfg), seed)
    trainer = Trainer(cfg, model, output_dir=".", steps_per_epoch=TRAIN_STEPS, device=dev,
                      log_every=1)  # saves no checkpoint: writes nothing
    watch = {n: p.detach().clone() for n, p in model.named_parameters()
             if n in ("image_encoder.blocks.0.attn.qkv.weight", "map_decoder.0.weight",
                      "topo_net.output_proj.weight")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    logs = trainer.train_epoch(batches, epoch=0)
    metrics = trainer.validate(batches[:1])
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
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
    if not all(np.isfinite(log["loss"]) and np.isfinite(log["grad_norm"]) for log in logs):
        raise SystemExit("a training loss or grad_norm is not finite")
    if any(log["skipped"] for log in logs) or len(logs) != TRAIN_STEPS:
        raise SystemExit("a training step was skipped or not logged")
    if not all(v > 0 for v in moved.values()):
        raise SystemExit("training did not move every watched parameter")
    if not np.isfinite(metrics["val_loss"]):
        raise SystemExit("validation loss is not finite")
    want = 12 * (TRAIN_STEPS + 1)  # every encoder attention of every forward pass
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
        ms = cuda_ms(lambda: torch.autograd.grad(wrapper(*leaves), leaves, g))
        plain_ms = cuda_ms(lambda: torch.autograd.grad(plain(*leaves), leaves, g))
        grad_rel = max(v[1] for k, v in errs.items() if k != "out")
        grad_scaled = max(v[2] for k, v in errs.items() if k != "out")
        ok = (all(v[3] for v in errs.values()) and errs["out"][1] <= TOL and grad_rel <= TOL
              and grad_scaled <= TOL)
        print(f"kernel {name}: out {tuple(g.shape)} max_abs_err {errs['out'][0]:.3e} "
              f"max_rel_err {errs['out'][1]:.3e} grad_max_rel_err {grad_rel:.3e} "
              f"grad_max_err/max|ref| {grad_scaled:.3e} (tol {TOL}) fwd+bwd kernel_ms {ms:.4f} "
              f"plain_bf16_ms {plain_ms:.4f} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"K6 {name} disagrees with its plain version: {errs}")
        results[name] = dict(max_abs_err=errs["out"][0], grad_max_rel_err=grad_rel,
                             ms=ms, plain_ms=plain_ms)
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
        adj = {}
        for i, y in enumerate(lines):
            for j, x in enumerate(lines):
                adj[(y, x)] = [(lines[i + di], lines[j + dj])
                               for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1))
                               if 0 <= i + di < len(lines) and 0 <= j + dj < len(lines)]
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
            dev: str = "cuda"):
    """One `python -m sam_road_tpu_torch.cli.train` run, in process: the
    flagship config's keys plus CLI and `overrides`, --dev_run, `steps`
    steps of one epoch, validation with panels, a checkpoint. Fails unless
    every loss is finite, no step was skipped, and the checkpoint and
    VAL_VIZ_COUNT panels exist. Returns the trainer, the config, the
    launches, the peak memory and the step times."""
    import torch

    from sam_road_tpu_torch.cli import train
    from sam_road_tpu_torch.config import load_config, read_flat_yaml, write_flat_yaml
    from sam_road_tpu_torch.ops import _build

    values = read_flat_yaml(FLAGSHIP)
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
                          "--device", dev, "--data_root", data_root, "--output_dir", out])
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


def clean_step_seconds(trainer, seed: int):
    """Seconds per step of `trainer` without the loader: 3 more steps over
    train_batches (the same geometry), the mean of the last 2. Producer
    threads hold the GIL while they run, which slows the host side of a
    step the loader feeds."""
    start = len(trainer.history)
    trainer.train_epoch(train_batches(3, seed), epoch=1)
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


def run_training_cli(seed: int, dev: str = "cuda"):
    """Phase 9c: the training CLI over a generated 1024 px Cityscale-format
    dataset at ViT-B 512 px, batch 16, bf16: FUSED_ENCODER_TRAIN on (K6) and
    off (K5), each also with REMAT_ENCODER, then the checkpoint restored into
    a fresh Trainer and the loader timed alone. Returns the launches of the
    FUSED_ENCODER_TRAIN run."""
    import torch

    from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random
    from sam_road_tpu_torch.training.harness import Trainer, applied_updates

    work = tempfile.mkdtemp(prefix="samroad_cli_")
    try:
        t = time.time()
        data_root = os.path.join(work, "data")
        write_cityscale_fixture(data_root, CLI["IMAGE_SIZE"])
        print(f"wrote the Cityscale-format fixture in {time.time() - t:.1f} s", flush=True)
        fused = run_cli(data_root, work, "fused", {}, CLI_STEPS, dev)
        want = {k: n * CLI_STEPS for k, n in K6_PER_FORWARD.items()}
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

        time_loader(loader_cfg, data_root, 4, 4)
        time_loader(loader_cfg, data_root, 1, 2)
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


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
    from sam_road_tpu_torch.ops import _build

    t = time.time()
    _build.kernels()
    print(f"built CUDA kernels in {time.time() - t:.1f} s", flush=True)
    t = time.time()
    nms_lib(), pairs_lib()
    print(f"built host native libs in {time.time() - t:.1f} s", flush=True)

    phase("3 kernels vs plain at the bench shapes (B=32)")
    results = check_kernels(32)

    phase("4 fused encoder vs eager encoder")
    check_encoder(SEED)

    phase("5 engine on the bench workload")
    launches = run_engine(SEED, BENCH, REGION, {
        "ln_dense": 12, "window_attention_rows_grid": 8, "attention_relpos_rows": 4,
        "proj_ln_mlp_residual": 12})

    phase("6 K5 fused_attention vs plain, forward and gradients")
    flash = check_flash_attention()
    window = flash["window 14x14"]  # 8 of the 12 launches of a forward pass
    results["fused_attention"] = dict(
        max_abs_err=max(r["max_abs_err"] for r in flash.values()), ms=window["ms"],
        plain_ms=window["plain_ms"], shapes=flash)

    phase(f"7 training: {TRAIN_STEPS} steps and validation at ViT-B 512 px, batch 16, bf16")
    launches.update(run_training(SEED))

    phase(f"8 engine on a {EAGER_REGION} px region, FUSED_ENCODER off (K5)")
    run_engine(SEED, {**BENCH, "FUSED_ENCODER": False}, EAGER_REGION, {"fused_attention": 12})

    phase("9 training CLI with FUSED_ENCODER_TRAIN (K6) at ViT-B 512 px, batch 16, bf16")
    k6 = check_k6()
    check_train_encoder(SEED)
    k6_launches = run_training_cli(SEED)

    kernels = []
    for name, (src, replaces) in KERNEL_META.items():
        r = results[name]
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=launches[name], max_abs_err=r["max_abs_err"],
                            ms=r["ms"], plain_ms=r["plain_ms"],
                            **({"shapes": r["shapes"]} if "shapes" in r else {})))
    for name, (kernel, src, replaces) in K6_META.items():  # K6: forward and backward
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=k6_launches[name], forward_kernel=kernel, **k6[name]))
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
