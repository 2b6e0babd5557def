"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels,
checks and times each against its plain PyTorch version at the bench
shapes, checks the fused encoder against the eager one, then drives the
engine over the bench workload (a 2048 px region, ViT-B at 512 px, batch 32,
bf16, random weights from a seed) and shows that it ran through every
kernel.

    python3 chip_smoke.py

The last line of a passing run is {"ok": true, "device": {...}}; any failure
exits nonzero without it. Needs CUDA; never falls back to the CPU.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
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
SEED = 0  # random weights (torch.Generator) for phases 4 and 5
KERNEL_META = {  # wrapper -> (CUDA source, the TPU kernel it replaces)
    "ln_dense": ("sam_road_tpu_torch/csrc/gemm.cu", "sam_road_tpu/ops/fused_ln.py:61"),
    "window_attention_rows_grid": ("sam_road_tpu_torch/csrc/window_attention.cu",
                                   "sam_road_tpu/ops/fused_block.py:308"),
    "attention_relpos_rows": ("sam_road_tpu_torch/csrc/relpos_attention.cu",
                              "sam_road_tpu/ops/attention.py:188"),
    "proj_ln_mlp_residual": ("sam_road_tpu_torch/csrc/gemm.cu", "sam_road_tpu/ops/fused_ln.py:188"),
}


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


def check_encoder(seed: int, dev: str = "cuda"):
    """Phase 4: fused encoder (kernels, bf16) against the eager encoder
    (fp32) on 4 patches; cosine similarity >= COS_MIN."""
    import torch

    from sam_road_tpu_torch.config import load_config
    from sam_road_tpu_torch.models.fast_encoder import encoder_forward_fused
    from sam_road_tpu_torch.models.sam_road import PIXEL_MEAN, PIXEL_STD, SAMRoad, init_random

    model = init_random(SAMRoad.from_config(load_config(overrides=BENCH)), seed).to(dev).eval()
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


def run_engine(seed: int, dev: str = "cuda"):
    """Phase 5: the bench workload through the engine; returns launches."""
    from sam_road_tpu_torch.config import load_config
    from sam_road_tpu_torch.inference.engine import TiledInferenceEngine
    from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random
    from sam_road_tpu_torch.ops import _build

    cfg = load_config(overrides=BENCH)
    model = init_random(SAMRoad.from_config(cfg), seed)
    img = np.random.default_rng(0).integers(0, 255, size=(REGION, REGION, 3), dtype=np.uint8)
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
    batches = -(-BENCH["INFER_PATCHES_PER_EDGE"] ** 2 // BENCH["INFER_BATCH_SIZE"])
    want = {"ln_dense": 12 * batches, "window_attention_rows_grid": 8 * batches,
            "attention_relpos_rows": 4 * batches, "proj_ln_mlp_residual": 12 * batches}
    if launches != want:
        raise SystemExit(f"main path launches {launches}, expected {want}")
    if nodes.shape[0] == 0 or edges.shape[0] == 0:
        raise SystemExit("engine produced an empty graph")
    if kp.shape != (REGION, REGION) or kp.max() == kp.min() or road.max() == road.min():
        raise SystemExit("engine masks are constant or misshapen")
    # the uint8 masks cannot show a NaN: check the float scores of one patch
    import torch

    p, m = BENCH["PATCH_SIZE"], BENCH["SAMPLE_MARGIN"]
    crop = torch.from_numpy(img[m:m + p, m:m + p]).to(dev)[None].float()
    with torch.no_grad():
        scores, emb = engine.model.infer_masks_and_features(crop, engine.encoder)
    if not (torch.isfinite(scores).all() and torch.isfinite(emb.float()).all()):
        raise SystemExit("engine mask scores or features hold a NaN or inf")
    return launches


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
    launches = run_engine(SEED)

    kernels = []
    for name, (src, replaces) in KERNEL_META.items():
        r = results[name]
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=launches[name], max_abs_err=r["max_abs_err"],
                            ms=r["ms"], plain_ms=r["plain_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
