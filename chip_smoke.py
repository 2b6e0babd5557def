"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels,
checks and times each against its plain PyTorch version at the bench
shapes, checks the fused encoder against the eager one, drives the engine
over the bench workload (a 2048 px region, ViT-B at 512 px, batch 32, bf16,
random weights from a seed), checks and times K5 (forward and gradients),
takes training steps at ViT-B 512 px, batch 16, bf16, runs a region
through the eager encoder (FUSED_ENCODER off), drives the training CLI
over a generated Cityscale-format dataset with FUSED_ENCODER_TRAIN (K6:
K1-K4 under autograd), then checks K7, K8 and K10 (the PAD_FREE / WIN_*
modes) bit-equal to K1, K4 and K2 and drives the inference CLI over two
generated 2048 px tiles from a SAM-format checkpoint in each mode and the
calibration CLI, showing that each path ran through its kernels. Every
kernel's time sits beside its bound (bytes or operations at the card's
peak rates) and, where one PyTorch call computes the same function, that
call's time.

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
PEAK_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA's data sheet)
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(flops: float, moved: float) -> dict:
    """The least time the card could take: the larger of the operations at
    the bf16 tensor-core peak and the bytes (each input read once, each
    output written once) at the HBM peak."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, moved / PEAK_BYTES * 1e3
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
    if name.startswith("attention_relpos_rows"):  # q [B, heads, N, hd]
        q = args[0]
        return 4.0 * q.shape[0] * q.shape[1] * q.shape[2] ** 2 * q.shape[3]
    if name.startswith("fused_attention"):  # q, k [B, heads, N, D], v [.., hd]
        q, v = args[0], args[2]
        return 2.0 * q.shape[0] * q.shape[1] * q.shape[2] ** 2 * (q.shape[3] + v.shape[3])
    raise KeyError(name)


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
    return None


def timing_row(name: str, args, out, kern, plain, fwd_bwd: bool = False) -> dict:
    """ms (kernel), plain_ms, library_ms and the bound of one call."""
    import torch

    ms = cuda_ms(kern)
    plain_ms = cuda_ms(plain)
    flops = kernel_flops(name, args)
    moved = nbytes(*args) + nbytes(out)
    lib = None if fwd_bwd else library_call(name, args)
    if fwd_bwd:  # + the gradient of every input, the cotangent read once
        flops, moved = 3 * flops, 2 * moved
    lib_ms = None
    if lib is not None:
        with torch.no_grad():
            lib_ms = cuda_ms(lib)
        del lib
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **bound(flops, moved))


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
        del ref, err
        row = timing_row(name, args, got, lambda: kern(*args), lambda: plain(*args))
        ok = finite and max_rel <= TOL
        print(f"kernel {name}: shape {tuple(got.shape)} max_abs_err {max_abs:.3e} "
              f"max_rel_err {max_rel:.3e} (tol {TOL}) {fmt_times(row)} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"kernel {name} disagrees with its plain version")
        results[name] = dict(max_abs_err=max_abs, **row)
        del got
    return results


def fmt_times(row: dict) -> str:
    lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
    return (f"kernel_ms {row['ms']:.4f} plain_bf16_ms {row['plain_ms']:.4f} library_ms {lib} "
            f"bound_ms {row['bound_ms']:.4f} ({row['bound_by']})")


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
            out = torch.empty_like(v)
            row = timing_row("fused_attention", (q, k, v), out,
                             lambda: attention.fused_attention(q, k, v),
                             lambda: attention.fused_attention_plain(q, k, v))
        ok = finite and fwd_rel <= TOL and bwd_rel <= TOL
        print(f"kernel fused_attention {name}: q {tuple(q.shape)} v {tuple(v.shape)} "
              f"max_abs_err {max_abs:.3e} max_rel_err {fwd_rel:.3e} grad_max_rel_err "
              f"{bwd_rel:.3e} (tol {TOL}) {fmt_times(row)} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise SystemExit(f"fused_attention disagrees with its plain version at {name}")
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
        default_ms = cuda_ms(default_way)
        ok = same and max_rel <= TOL and bool(torch.isfinite(got.float()).all())
        print(f"kernel {name}: shape {tuple(got.shape)} bit-equal to the default path "
              f"{same} max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} (tol {TOL}) "
              f"{fmt_times(row)} default_path_ms {default_ms:.4f} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise SystemExit(f"kernel {name} disagrees with the default path or its plain version")
        results[name] = dict(max_abs_err=max_abs, default_path_ms=default_ms, **row)
        del got
    return results


ENCODER_MODES = {"default": {}, "PAD_FREE": {"PAD_FREE": True},
                 "PAD_FREE+WIN_GROUP_BATCH=4": {"PAD_FREE": True, "WIN_GROUP_BATCH": 4},
                 "WIN_ROLLED_ROWS": {"WIN_ROLLED_ROWS": True}}


def set_encoder_switches(switches: dict) -> None:
    """models/fast_encoder.py's module switches: the defaults, then these."""
    from sam_road_tpu_torch.models import fast_encoder as fe

    fe.PAD_FREE, fe.WIN_GROUP_BATCH, fe.WIN_ROLLED_ROWS = False, 1, False
    for key, value in switches.items():
        setattr(fe, key, value)


def check_encoder_modes(seed: int, dev: str = "cuda", rounds: int = 4):
    """Phase 10b: the fused encoder at the bench geometry (32 patches, bf16)
    in each ENCODER_MODES entry, bit-equal to the default; the ms of a
    forward in each mode, as `rounds` medians of 5 taken in turns (every
    other round in reverse order), and their median."""
    import torch

    from sam_road_tpu_torch.config import load_config
    from sam_road_tpu_torch.models.fast_encoder import encoder_forward_fused
    from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random

    model = init_random(SAMRoad.from_config(load_config(overrides=BENCH)), seed).to(dev).eval()
    enc = model.image_encoder
    gen = torch.Generator(device=dev).manual_seed(11)
    p = BENCH["PATCH_SIZE"]
    x = model.normalize(torch.randint(0, 255, (BENCH["INFER_BATCH_SIZE"], p, p, 3),
                                      generator=gen, device=dev))
    outs, times = {}, {name: [] for name in ENCODER_MODES}
    try:
        for name, switches in ENCODER_MODES.items():
            set_encoder_switches(switches)
            outs[name] = encoder_forward_fused(enc, x)
        for r in range(rounds):
            for name in list(ENCODER_MODES)[::(-1) ** r]:
                set_encoder_switches(ENCODER_MODES[name])
                times[name].append(cuda_ms(lambda: encoder_forward_fused(enc, x), reps=5,
                                           warmup=1))
    finally:
        set_encoder_switches({})
    same = {name: torch.equal(out, outs["default"]) for name, out in outs.items()}
    print("fused encoder forward, 32 patches, bf16, ms (median of the rounds; each round): "
          + " | ".join(f"{name} bit-equal {same[name]} {statistics.median(t):.3f} ("
                       + ", ".join(f"{v:.3f}" for v in t) + ")" for name, t in times.items()),
          flush=True)
    if not all(same.values()):
        raise SystemExit(f"an encoder mode is not bit-equal to the default: {same}")
    return times


def write_sam_checkpoint(path: str, seed: int):
    """A SAM-format .pth (image_encoder.* keys, fp32) from seeded weights at
    1024 px geometry: the 64x64 pos embed and 127-row global rel-pos tables
    that load_and_convert resizes for 512 px."""
    import torch

    from sam_road_tpu_torch.config import load_config
    from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random

    model = init_random(SAMRoad.from_config(load_config(overrides={**BENCH, "PATCH_SIZE": 1024})),
                        seed)
    torch.save({f"image_encoder.{k}": v for k, v in model.image_encoder.state_dict().items()},
               path)


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

    # thresholds by quantile of a first region's masks (see run_engine)
    model, mismatched = load_weights(pth, cfg)
    engine = TiledInferenceEngine(cfg, model, dev)
    engine.config.ITSC_THRESHOLD = engine.config.ROAD_THRESHOLD = 1.0
    tile0 = read_rgb_img(os.path.join(sat, f"region_{test_ids[0]}_sat.png"))
    _, _, kp, road = engine.infer_one_img(tile0)
    values["ITSC_THRESHOLD"] = float(np.quantile(kp / 255.0, 0.99))
    values["ROAD_THRESHOLD"] = float(np.quantile(road / 255.0, 0.92))
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
            set_encoder_switches(switches)
            _build.reset_launches()
            t = time.time()
            out = infer.main(["--config", cfg_path, "--checkpoint", pth, "--data_root", data,
                              "--output_dir", name, "--max_tiles", str(INFER_TILES),
                              "--device", dev])
            if dev == "cuda":
                torch.cuda.synchronize()
            wall = time.time() - t
            launches = dict(_build.launches)
            set_encoder_switches({})
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
        set_encoder_switches({})
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
        window, max_abs_err=max(r["max_abs_err"] for r in flash.values()), shapes=flash)

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
        check_encoder_modes(SEED)
        infer_runs = run_infer_cli(SEED, work)
        run_test_cli(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    grid_launches = {**infer_runs["pad_free"]["launches"],
                     **infer_runs["pad_free_g4"]["launches"], **infer_runs["rolled"]["launches"]}

    kernels = []
    for name, (src, replaces) in KERNEL_META.items():
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=launches[name], **results[name]))
    for name, (kernel, src, replaces) in K6_META.items():  # K6: forward and backward
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=k6_launches[name], forward_kernel=kernel, **k6[name]))
    for name, (src, replaces) in K10_META.items():  # K7, K8, K10
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=grid_launches[name], **grid[name]))
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
