"""The eager encoder's parts in ms and TFLOP/s (counterpart of the
repository's tools/profile_encoder.py), through the port's models/vit.py
with FLASH_ATTENTION (every attention on K5).

At the bench geometry (ViT-B, 512 px patches: a 32 x 32 token grid, B 32,
bf16 activations, fp32 weights cast per call as the encoder casts them):
  full_encoder               patch embedding, 12 blocks, neck;
  windowed_block[_norelpos]  one 14 x 14-window block, with and without the
                             decomposed rel-pos bias (use_rel_pos);
  global_block[_norelpos]    one global block, with and without it;
  mlp_only                   x + MLP(x): two dense layers and the exact GELU.
Each reads ms a call and TFLOP/s from `encoder_flops`'s count. Timing:
`utils/profiling.py::ms_per_call` (CUDA events around `iters` calls; the
host clock on the CPU), one warm call of each part first, then `rounds`
rounds with the parts in turns; the least of each part's rounds. The JAX
tool's scan inside one jit is left out.

    python -m sam_road_tpu_torch.tools.profile_encoder [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from sam_road_tpu_torch.tools import bench
from sam_road_tpu_torch.utils.profiling import ms_per_call


def block_flops(tokens: int, dim: int, side: int, windows: int, rel_pos: bool,
                mlp_ratio: float = 4.0, mlp_tokens: int | None = None) -> float:
    """Multiply-adds x 2 of one block over `windows` attention windows of
    side x side tokens (a global block: one window of the whole grid;
    `tokens` = windows * side^2, the zero-padded grid of a windowed block,
    which SAM attends over) and the MLP over `mlp_tokens` (the real tokens):
    qkv and proj on every attended token, q k^T and p v over all heads, the
    rel-pos bias rows q.Rh and q.Rw (side columns each), the two MLP layers.
    LayerNorms, softmax and GELU are not counted."""
    per = side * side
    hidden = int(dim * mlp_ratio)
    flops = 2 * tokens * dim * 3 * dim + 2 * tokens * dim * dim  # qkv, proj
    flops += 2 * 2 * windows * per * per * dim  # scores and p v
    if rel_pos:
        flops += 2 * 2 * tokens * side * dim
    flops += 2 * 2 * (tokens if mlp_tokens is None else mlp_tokens) * dim * hidden
    return float(flops)


def encoder_flops(img_size: int, dim: int, depth: int, window: int, global_idx,
                  out_chans: int = 256, patch: int = 16) -> float:
    """One patch through the encoder: the patch embedding, `depth` blocks
    (windowed over the zero-padded window grid, global over the whole
    grid) and the neck's 1 x 1 and 3 x 3 convolutions. ViT-B at 512 px:
    227.1 GFLOP (the JAX tool's analytic 226.1 counts the windowed blocks'
    qkv and proj over the real tokens)."""
    grid = img_size // patch
    N = grid * grid
    nw = -(-grid // window)
    flops = 2 * N * patch * patch * 3 * dim
    for i in range(depth):
        if i in global_idx:
            flops += block_flops(N, dim, grid, 1, True)
        else:
            flops += block_flops(nw * nw * window * window, dim, window, nw * nw, True,
                                 mlp_tokens=N)
    flops += 2 * N * dim * out_chans + 2 * N * out_chans * out_chans * 9
    return float(flops)


def main(device: str = "cuda", *, batch: int = 32, img_size: int = 512,
         sam_version: str = "vit_b", iters: int = 20, rounds: int = 3,
         seed: int = bench.SEED) -> dict:
    """Returns and prints {part}_ms and {part}_tflops. The geometry
    arguments exist so that a test can run the tool small."""
    import torch

    from sam_road_tpu_torch.models.sam_road import init_random
    from sam_road_tpu_torch.models.vit import ENCODER_SPECS, Block, ImageEncoderViT

    dev = bench.require_device(device)
    spec = ENCODER_SPECS[sam_version]
    dim, heads, depth = spec["embed_dim"], spec["num_heads"], spec["depth"]
    win, gidx = 14, tuple(spec["global_attn_indexes"])
    grid = img_size // 16
    DT = torch.bfloat16
    rng = np.random.default_rng(0)
    x_tok = torch.from_numpy((rng.normal(size=(batch, grid, grid, dim)) * 0.02)
                             .astype(np.float32)).to(dev, DT)
    x_img = torch.from_numpy(rng.normal(size=(batch, img_size, img_size, 3))
                             .astype(np.float32)).to(dev)

    nw = -(-grid // win)
    padded = nw * nw * win * win
    parts, flops = {}, {}
    for name, window, rel in (("windowed_block", win, True),
                              ("windowed_block_norelpos", win, False),
                              ("global_block", 0, True), ("global_block_norelpos", 0, False)):
        blk = init_random(Block(dim, heads, 4.0, window, (grid, grid), use_rel_pos=rel),
                          seed).to(dev).eval()
        parts[name] = (lambda b: lambda: b(x_tok))(blk)
        flops[name] = (block_flops(padded, dim, win, nw * nw, rel, mlp_tokens=grid * grid)
                       if window else block_flops(grid * grid, dim, grid, 1, rel)) * batch
    mlp = blk.mlp
    parts["mlp_only"] = lambda: x_tok + mlp(x_tok)
    flops["mlp_only"] = 2.0 * 2 * grid * grid * dim * 4 * dim * batch
    enc = init_random(ImageEncoderViT(img_size=img_size, embed_dim=dim, depth=depth,
                                      num_heads=heads, window_size=win,
                                      global_attn_indexes=gidx, dtype=DT), seed).to(dev).eval()
    parts["full_encoder"] = lambda: enc(x_img)
    flops["full_encoder"] = encoder_flops(img_size, dim, depth, win, gidx) * batch

    times = {name: [] for name in parts}
    with torch.no_grad():
        for name, fn in parts.items():
            fn()
            print(f"# {name}: ran", flush=True)
        for _ in range(rounds):
            for name, fn in parts.items():
                times[name].append(ms_per_call(fn, iters, dev))
    results = {"device": bench.device_name(dev), "batch": batch, "img_size": img_size,
               "sam_version": sam_version}
    for name, ts in times.items():
        ms = min(ts)
        results[name + "_ms"] = ms
        results[name + "_ms_rounds"] = ts
        results[name + "_gflop"] = flops[name] / 1e9
        results[name + "_tflops"] = flops[name] / (ms * 1e-3) / 1e12
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    main(ap.parse_args().device)
