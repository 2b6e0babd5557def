"""Encoder-block variants, timed as whole blocks (B = 32 patches of 32 x 32
tokens, ViT-B: C 768, 12 heads, bf16): the counterpart of the repository's
tools/experiment_block_variants.py, on the same default_rng(0) input (x
0.02), with its JSON keys, for windowed (window 14) and global (N = 1024)
blocks:

  flash   the port's models/vit.py Block with use_flash: the rel-pos bias
          folded into q and k, then K5 (fused_attention)
  xla     the same Block with use_flash off: the bias added to the score
          matrix in plain ops; the reference flash and inker are held to
  inker   InkerBlock: q and k stay 64 wide and T5 (inker_attention) builds
          the rel-pos bias in the kernel from row-expanded tables

T5 replaces the tool's inker_attention (make_inker_kernel, :62-88):
s = q.k^T hd^-0.5 + sum_c q[n, c] rh[n, m // win_w, c] + sum_c q[n, c]
rw[n, m % win_w, c] in fp32 (the bias from the unscaled q), p normalised,
then rounded to bf16 for p.v. On a window (N <= 256) that is K13's function
at one head, and T5 runs K13's head-split table mode of
csrc/window_attention.cu, one (window, head) a block: no new device code. On
the global grid it runs MODE_TABLE of K3's flash loop
(csrc/relpos_attention.cu), which builds each query row's bias rows into
shared memory before the key loop. Bounds at the tool's shapes: windowed
347 MB of HBM traffic (0.104 ms at 3.35 TB/s), global 106 GFLOP (0.107 ms
at 989 TFLOP/s).

All three blocks carry the same seeded weights (InkerBlock's are Block's
under the JAX module's names, loaded as experiment_relpos_kernel's SelBlock
loads them), so each variant's `<label>_l1` (the L1 norm of one
application to x) can be held to the `xla` one's. Timing: CUDA events
around `iters` applications, each fed the last one's output as the JAX
tool's lax.scan does, the least per-application time of `reps` runs (host
clock with --device cpu, plain versions). Each variant runs 1 + reps *
iters times, so each kernel's launches are exact.

    python -m sam_road_tpu_torch.tools.experiment_block_variants [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from sam_road_tpu_torch.models.vit import (
    Block,
    layer_norm,
    linear,
    window_partition,
    window_unpartition,
)
from sam_road_tpu_torch.ops import _build
from sam_road_tpu_torch.ops.fused_block import _table_rows, expand_rel_pos
from sam_road_tpu_torch.tools.experiment_relpos_kernel import SelBlock
from sam_road_tpu_torch.utils.profiling import ms_per_call

# each kernel variant -> the plain block it is held to
PAIRS = {f"{lb}_{sub}": f"{lb}_xla" for lb in ("win", "glob") for sub in ("flash", "inker")}
TABLE_ROWS = 64  # MODE_TABLE holds win_h + win_w bias rows a query row


def inker_attention_plain(q, k, v, rh_exp, rw_exp, win_h: int, win_w: int):
    """Follows make_inker_kernel (tools/experiment_block_variants.py:62-88):
    q, k, v [BH, N, hd], rh_exp [N, win_h, hd], rw_exp [N, win_w, hd]; s =
    q.k^T (fp32) hd^-0.5 + bh[n, m // win_w] + bw[n, m % win_w] with bh, bw
    from the unscaled q in fp32, p = softmax(s) rounded to v.dtype, p.v in
    fp32 -> [BH, N, hd] in v.dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    bh, bw = _table_rows(q, rh_exp, rw_exp)
    s = s.unflatten(-1, (win_h, win_w)) + bh[..., :, None] + bw[..., None, :]
    p = torch.softmax(s.flatten(-2), dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(v.dtype)


def inker_attention(q, k, v, rh_exp, rw_exp, win_h: int, win_w: int):
    """T5: q, k, v [BH, N, hd] (q unscaled), the expanded tables rh_exp [N,
    win_h, hd], rw_exp [N, win_w, hd] -> [BH, N, hd]. A square window of at
    most 196 tokens (14 x 14, the window kernels' largest) runs K13's table
    mode at one head; a grid of N % 64 == 0 tokens with win_w % 8 == 0 and
    win_h + win_w <= 64 runs MODE_TABLE of K3's loop. Raises for
    any other N and for a head_dim without an instance (64, 80)."""
    if _build.on_cpu(q):
        return inker_attention_plain(q, k, v, rh_exp, rw_exp, win_h, win_w)
    BH, N, hd = q.shape
    _build.require_head_dim(hd, "inker_attention")
    windowed = win_h == win_w and N <= 196
    if N != win_h * win_w or not (windowed or (N % 64 == 0 and win_w % 8 == 0
                                                 and win_h + win_w <= TABLE_ROWS)):
        raise ValueError(f"inker_attention has no kernel for N={N} on a {win_h}x{win_w} grid")
    bf = torch.bfloat16
    _build.require(q, "q", bf)
    for t, name in ((k, "k"), (v, "v")):
        _build.require(t, name, bf, q.shape)
    _build.require(rh_exp, "rh_exp", bf, (N, win_h, hd))
    _build.require(rw_exp, "rw_exp", bf, (N, win_w, hd))
    out = torch.empty_like(q)
    lib, ptrs = _build.kernels(), [t.data_ptr() for t in (q, k, v, rh_exp, rw_exp, out)]
    if windowed:  # one (window, head) a block, one head
        err = lib.samroad_window_attention_relpos_batched(*ptrs, BH, 1, hd, win_h, 1,
                                                          _build.stream_of(q))
    else:
        err = lib.samroad_relpos_attention_table(*ptrs, BH, N, win_h, win_w, hd,
                                                 _build.stream_of(q))
    _build.check(err, "inker_attention")
    _build.launches["inker_attention"] += 1
    return out


class InkerBlock(SelBlock):
    """tools/experiment_block_variants.py's InkerBlock (:105-144) under its
    names, which are SelBlock's (so are its parameters and load_block): LN
    -> (window partition) -> qkv -> T5 on the expanded rel-pos tables ->
    proj -> (unpartition) -> residual -> LN -> MLP (exact GELU) -> residual.
    window 0 is a global block over the whole (square) grid of side `grid`.
    Weights fp32, cast to the input's dtype at use."""

    def __init__(self, window: int, dim: int = 768, num_heads: int = 12, grid: int = 32):
        super().__init__(dim, num_heads, window or grid)
        self.window = window

    def forward(self, x):
        B, H, W, C = x.shape
        nh = self.num_heads
        ws, hd = self.window or H, C // nh
        N = ws * ws
        h = layer_norm(x, self.norm1)
        if self.window:
            h, pad_hw = window_partition(h, ws)
        Bw = h.shape[0]
        qkv = linear(h.reshape(Bw, N, C), self.qkv).reshape(Bw, N, 3, nh, hd)
        q, k, v = (t.reshape(Bw * nh, N, hd).contiguous() for t in qkv.permute(2, 0, 3, 1, 4))
        rh, rw = expand_rel_pos(self.rel_pos_h, self.rel_pos_w, ws, x.dtype)
        o = inker_attention(q, k, v, rh, rw, ws, ws)
        o = linear(o.reshape(Bw, nh, N, hd).transpose(1, 2).reshape(Bw, ws, ws, C), self.proj)
        if self.window:
            o = window_unpartition(o, ws, pad_hw, (H, W))
        x = x + o
        h = linear(F.gelu(linear(layer_norm(x, self.norm2), self.mlp_lin1)), self.mlp_lin2)
        return x + h


def main(device: str = "cuda", *, batch: int = 32, grid: int = 32, dim: int = 768,
         heads: int = 12, win: int = 14, iters: int = 20, reps: int = 3) -> dict:
    """Returns and prints {label_ms, label_l1} for label in {win, glob} x
    {flash, xla, inker}. The geometry arguments exist so that a test can run
    the tool small."""
    from sam_road_tpu_torch.models.sam_road import init_random

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to run the plain versions")
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(batch, grid, grid, dim)) * 0.02).astype(np.float32))
    x = x.to(dev, torch.bfloat16)

    def applications(fn):  # iters calls, each fed the last one's output
        h = x
        for _ in range(iters):
            h = fn(h)

    results = {}
    with torch.no_grad():
        for label, window in (("win", win), ("glob", 0)):
            flash = init_random(Block(dim, heads, 4.0, window, (grid, grid), use_flash=True), 0)
            xla = Block(dim, heads, 4.0, window, (grid, grid), use_flash=False)
            xla.load_state_dict(flash.state_dict())
            inker = InkerBlock(window, dim, heads, grid).load_block(flash)
            for sub, fn in (("flash", flash), ("xla", xla), ("inker", inker)):
                key = f"{label}_{sub}"
                fn.to(dev)
                results[key + "_l1"] = float(fn(x).float().abs().sum())
                results[key + "_ms"] = round(min(
                    ms_per_call(lambda: applications(fn), 1, dev) / iters for _ in range(reps)), 3)
                print(f"# {key}: {results[key + '_ms']} ms", flush=True)
    print(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    main(ap.parse_args().device)
