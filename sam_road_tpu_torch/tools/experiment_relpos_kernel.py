"""Rel-pos attention variants, timed as whole windowed blocks (B = 32
patches of 32 x 32 tokens, ViT-B: C 768, 12 heads, window 14, bf16): the
counterpart of the repository's tools/experiment_relpos_kernel.py, on the
same default_rng(0) input (x 0.02), with its JSON keys.

  v0_current   the port's models/vit.py Block with use_flash: the rel-pos
               folded into q and k (92 wide), then K5 (fused_attention), as
               the JAX Block runs its flash path by default
  v1_selector  SelBlock: q and k stay 64 wide; the bias rows qh = q.Rh,
               qw = q.Rw [BH, N, 14] come from two einsums of the unscaled q,
               and T4 (sel_attention) spreads them onto the keys
  V2 (SelBlock(combined=True)) raises NotImplementedError, as the JAX
  module does.

T4 replaces the tool's sel_attention (sel_kernel): K13's head-split
addressing with K11's bias rows read, s = q.k^T + qh[n, m // 14] +
qw[n, m % 14] in fp32 (q arrives pre-scaled, so scale 1), p normalised
before it is rounded for p.v; a mode of the per-window body in
csrc/window_attention.cu. Like K11, bound by latency and shared memory:
385 MB of HBM traffic (0.115 ms at 3.35 TB/s) at the tool's shapes.

Both blocks carry the same seeded weights (SelBlock's are Block's under the
JAX module's names), so each variant's `<label>_l1` (the L1 norm of one
application to x) can be held to `plain_block_l1`, the Block with the
rel-pos bias added to the score matrix in plain ops. Timing: CUDA events
around `iters` applications, each fed the last one's output as the JAX
tool's lax.scan does, the least per-application time of `reps` runs (host
clock with --device cpu, plain versions). Each variant runs 1 + reps *
iters times, so each kernel's launches are exact.

    python -m sam_road_tpu_torch.tools.experiment_relpos_kernel [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sam_road_tpu_torch.models.vit import (
    Block,
    layer_norm,
    linear,
    rel_pos_table,
    window_partition,
    window_unpartition,
)
from sam_road_tpu_torch.ops import _build
from sam_road_tpu_torch.utils.profiling import ms_per_call

PAIRS = {"v0_current": "plain_block", "v1_selector": "plain_block"}


def sel_attention_plain(q, k, v, qh, qw):
    """Follows sel_kernel (tools/experiment_relpos_kernel.py:62-79): q
    pre-scaled, s = q.k^T + qh[n, m // win] + qw[n, m % win] in fp32,
    p = exp(s - max) / sum rounded to v.dtype, p.v in fp32. q, k, v [BH, N,
    hd], qh, qw [BH, N, win] -> [BH, N, hd] in v.dtype."""
    win = qh.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s.unflatten(-1, (win, win)) + qh.float()[..., :, None] + qw.float()[..., None, :]
    p = torch.softmax(s.flatten(-2), dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(v.dtype)


def sel_attention(q, k, v, qh, qw):
    """T4: q (pre-scaled), k, v [BH, win*win, hd], bias rows qh, qw [BH,
    win*win, win] -> [BH, win*win, hd]; one (window, head) a block, as one
    Pallas program."""
    if _build.on_cpu(q):
        return sel_attention_plain(q, k, v, qh, qw)
    BH, N, hd = q.shape
    win = qh.shape[-1]
    if N != win * win:
        raise ValueError(f"sel_attention: {N} tokens are not a {win}x{win} window")
    _build.require_head_dim(hd, "sel_attention")
    bf = torch.bfloat16
    _build.require(q, "q", bf)
    for t, name in ((k, "k"), (v, "v")):
        _build.require(t, name, bf, q.shape)
    for t, name in ((qh, "qh"), (qw, "qw")):
        _build.require(t, name, bf, (BH, N, win))
    out = torch.empty_like(q)
    _build.check(_build.kernels().samroad_sel_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qh.data_ptr(), qw.data_ptr(), out.data_ptr(),
        BH, hd, win, _build.stream_of(q)), "sel_attention")
    _build.launches["sel_attention"] += 1
    return out


class SelBlock(nn.Module):
    """tools/experiment_relpos_kernel.py's SelBlock (:93-139) under its
    names: LN -> window partition -> qkv -> bias rows from the unscaled q
    -> T4 -> proj -> unpartition -> residual -> LN -> MLP (exact GELU) ->
    residual. Weights fp32, cast to the input's dtype at use."""

    def __init__(self, dim: int = 768, num_heads: int = 12, window_size: int = 14,
                 combined: bool = False):
        super().__init__()
        self.num_heads, self.window_size, self.combined = num_heads, window_size, combined
        hd = dim // num_heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * window_size - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * window_size - 1, hd))
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp_lin1 = nn.Linear(dim, 4 * dim)
        self.mlp_lin2 = nn.Linear(4 * dim, dim)

    def load_block(self, blk: Block) -> "SelBlock":
        """Take a models/vit.py Block's weights (InkerBlock, a subclass,
        takes a global Block's too)."""
        names = {"norm1": "norm1", "qkv": "attn.qkv", "rel_pos_h": "attn.rel_pos_h",
                 "rel_pos_w": "attn.rel_pos_w", "proj": "attn.proj", "norm2": "norm2",
                 "mlp_lin1": "mlp.lin1", "mlp_lin2": "mlp.lin2"}
        theirs, mine = blk.state_dict(), {}
        for key in self.state_dict():
            module, _, leaf = key.rpartition(".")
            mine[key] = theirs[f"{names[module]}.{leaf}" if module else names[leaf]]
        self.load_state_dict(mine)
        return self

    def forward(self, x):
        if self.combined:  # the JAX module's V2 is a placeholder that raises
            raise NotImplementedError
        ws, nh = self.window_size, self.num_heads
        N = ws * ws
        B, H, W, C = x.shape
        hd = C // nh
        shortcut = x
        h, pad_hw = window_partition(layer_norm(x, self.norm1), ws)
        Bw = h.shape[0]
        qkv = linear(h.reshape(Bw, N, C), self.qkv).reshape(Bw, N, 3, nh, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # [Bw, heads, N, hd]
        Rh = rel_pos_table(ws, self.rel_pos_h).to(x.dtype)  # (ws, ws, hd)
        Rw = rel_pos_table(ws, self.rel_pos_w).to(x.dtype)
        r_q = q.reshape(Bw, nh, ws, ws, hd)
        qh = torch.einsum("bnhwc,hkc->bnhwk", r_q, Rh)
        qw = torch.einsum("bnhwc,wkc->bnhwk", r_q, Rw)
        BH = Bw * nh
        o = sel_attention(*((t.reshape(BH, N, -1).contiguous())
                            for t in (q * hd ** -0.5, k, v, qh, qw)))
        o = o.reshape(Bw, nh, N, hd).transpose(1, 2).reshape(Bw, ws, ws, C)
        x = shortcut + window_unpartition(linear(o, self.proj), ws, pad_hw, (H, W))
        h = linear(F.gelu(linear(layer_norm(x, self.norm2), self.mlp_lin1)), self.mlp_lin2)
        return x + h


def main(device: str = "cuda", *, batch: int = 32, grid: int = 32, dim: int = 768,
         heads: int = 12, win: int = 14, iters: int = 20, reps: int = 3) -> dict:
    """Returns and prints {label_ms, label_l1}. The geometry arguments exist
    so that a test can run the tool small."""
    from sam_road_tpu_torch.models.sam_road import init_random

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to run the plain versions")
    DT = torch.bfloat16
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(batch, grid, grid, dim)) * 0.02).astype(np.float32))
    x = x.to(dev, DT)
    blk = init_random(Block(dim, heads, 4.0, win, (grid, grid), use_flash=True), 0).to(dev)
    plain = Block(dim, heads, 4.0, win, (grid, grid), use_flash=False).to(dev)
    plain.load_state_dict(blk.state_dict())
    sel = SelBlock(dim, heads, win).to(dev).load_block(blk)

    def applications(fn):  # iters calls, each fed the last one's output
        h = x
        for _ in range(iters):
            h = fn(h)

    results = {}
    with torch.no_grad():
        results["plain_block_l1"] = float(plain(x).float().abs().sum())
        for label, fn in (("v0_current", blk), ("v1_selector", sel)):
            results[label + "_l1"] = float(fn(x).float().abs().sum())
            results[label + "_ms"] = round(
                min(ms_per_call(lambda: applications(fn), 1, dev) / iters for _ in range(reps)), 2)
            print(f"# {label}: {results[label + '_ms']} ms", flush=True)
    print(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    main(ap.parse_args().device)
