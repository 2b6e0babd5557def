"""Stage-level timing of the fused windowed block (ViT-B flagship geometry:
B = 32 patches of 32 x 32 tokens, C 768, 12 heads, window 14, bf16): the
counterpart of the repository's tools/profile_windowed_block.py, through
the port's models/fast_encoder.py. Times nested prefixes of the block:

  ln_qkv:   LN1 + qkv dense (K1)
  biasrows: + pad to the window grid + rel-pos bias-row einsums
  attn:     + grid-layout window attention (K2) and the crop
  full:     + proj / LN2 / MLP / residual tail (K4): the whole block

The deltas localise the block's time across its stages. Timing: CUDA events
around `iters` calls of a stage, the stages in turns for `rounds` rounds,
the least per-call time (host clock with --device cpu, plain versions).
Each stage runs 1 + rounds * iters times.

    python -m sam_road_tpu_torch.tools.profile_windowed_block [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from sam_road_tpu_torch.utils.profiling import ms_per_call

STAGES = ("ln_qkv", "biasrows", "attn", "full")


def main(device: str = "cuda", *, batch: int = 32, grid: int = 32, dim: int = 768,
         heads: int = 12, ws: int = 14, iters: int = 20, rounds: int = 5) -> dict:
    """Returns and prints {stage_ms}. The geometry arguments exist so that a
    test can run the tool small."""
    import torch
    import torch.nn.functional as F

    from sam_road_tpu_torch.models import fast_encoder as fe
    from sam_road_tpu_torch.models.sam_road import init_random
    from sam_road_tpu_torch.models.vit import Block
    from sam_road_tpu_torch.ops.fused_block import window_attention_rows_grid

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to run the plain versions")
    DT = torch.bfloat16
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(batch, grid, grid, dim)) * 0.02).astype(np.float32))
    x = x.to(dev, DT)
    # fp32 weights on the device, cast per call as the encoder casts them
    blk = init_random(Block(dim, heads, 4.0, ws, (grid, grid)), 0).to(dev)
    pad = (ws - grid % ws) % ws

    def ln_qkv(x):
        B, H, W, C = x.shape
        return fe._ln_qkv(x.reshape(-1, C), blk, DT, False, False).reshape(B, H, W, 3 * C)

    def biasrows(x):
        qkv_p = F.pad(ln_qkv(x), (0, 0, 0, pad, 0, pad))
        return (qkv_p,) + fe._bias_rows(qkv_p, blk.attn, heads, ws)

    def attn(x):
        qkv_p, bh, bw = biasrows(x)
        out = window_attention_rows_grid(qkv_p, fe._w(blk.attn.qkv.bias, DT), bh, bw, ws, heads)
        return out[:, :grid, :grid]

    def full(x):
        return fe._windowed_block(x, blk, heads, ws)

    stages = dict(zip(STAGES, (ln_qkv, biasrows, attn, full)))

    with torch.no_grad():
        for name, fn in stages.items():
            fn(x)
            print(f"# {name}: ran", flush=True)
        times = {name: [] for name in stages}
        for _ in range(rounds):
            for name, fn in stages.items():
                times[name].append(ms_per_call(lambda: fn(x), iters, dev))
    results = {name + "_ms": min(ts) for name, ts in times.items()}
    print(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    main(ap.parse_args().device)
