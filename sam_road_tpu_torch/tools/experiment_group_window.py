"""Grouped block-diagonal windowed attention against the production rows
kernel on the card (288 windows of 14 x 14 tokens, ViT-B: C 768, 12 heads,
bf16): the counterpart of the repository's tools/experiment_group_window.py,
on the same default_rng(0) inputs (x 0.3), with its JSON keys.

The tool's question: folding g windows into the M dimension of one product
per head cuts the count of small serial products g-fold, at the cost of
g-fold wasted score work and exp. Variants:
  prod_rows   K11 (ops/fused_block.py::window_attention_rows), the reference
  diag_g{g}   T1 (diag_attn) at g = 2, 4, 8 windows a fold
each with `<label>_reldiff`, the relative L1 distance of its output from
K11's, and `<label>_ms` (or "WRONG (rel ...)" above 1e-2, as the JAX tool
marks it), with every round's time in `<label>_all`.

T1 replaces the tool's diag_attn (_diag_kernel). As there, the layout work
stays outside the kernel: the g windows' qkv rows are stacked by a reshape
to [nG, g N, 3C] and the bias rows [bh | bw] transposed to [nG, heads, g N,
2 win]. The kernel (csrc/relpos_attention.cu, K3's flash loop in its
MODE_DIAG) computes every (g N) x (g N) score of a head, adds the bias rows
spread over the key's window position, masks the cross-window scores to
-1e30 and keeps an online fp32 softmax over 64-key tiles (g N = 392, 784,
1568 are no multiple of 64: the last tiles are ragged). Its HBM bound is
385 MB (0.115 ms at 3.35 TB/s); its score work is 34 g GFLOP, so from g = 4
on the operations bound it.

Timing: CUDA events around ITERS calls, the variants in turns for 4 rounds,
the least per-call time (host clock with --device cpu, where the kernels'
wrappers take their plain versions). A variant that raises stops the tool:
the JAX tool's catch-all ("FAIL: ...") and its TPU weather canary have no
counterpart. K11 runs 2 + rounds * iters times, each diag_g{g} 1 + rounds *
iters, so the launches are exact.

    python -m sam_road_tpu_torch.tools.experiment_group_window [g1,g2,...] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from sam_road_tpu_torch.ops import _build
from sam_road_tpu_torch.ops.fused_block import window_attention_rows
from sam_road_tpu_torch.utils.profiling import ms_per_call

GROUPS = (2, 4, 8)


def _fold(qkv_w, bh, bw, g: int):
    """diag_attn's layout work (tools/experiment_group_window.py:91-98):
    qkv_w [nW, N, 3C] -> [nW / g, g N, 3C]; bh, bw [nW, heads, N, win] ->
    [bh | bw] as [nW / g, heads, g N, 2 win] in qkv_w's dtype."""
    nW, N, C3 = qkv_w.shape
    heads, win = bh.shape[1], bh.shape[-1]
    if nW % g:
        raise ValueError(f"{g} windows a fold do not divide {nW}")
    nG = nW // g
    bhw = torch.cat([bh, bw], dim=-1).reshape(nG, g, heads, N, 2 * win)
    bhw = bhw.transpose(1, 2).reshape(nG, heads, g * N, 2 * win)
    return qkv_w.reshape(nG, g * N, C3), bhw.to(qkv_w.dtype).contiguous()


def _diag_plain(qkv_g, bhw, g: int):
    """Follows _diag_kernel (:59-89) on the folded layout, every head at
    once: s = q.k^T in fp32 * scale, the bias rows times the stacked 0/1
    selector, tiled over the g column blocks, scores across windows set to
    -1e30, fp32 softmax normalised, p in the input dtype, p.v in fp32."""
    nG, gN, C3 = qkv_g.shape
    heads, win = bhw.shape[1], bhw.shape[-1] // 2
    C, N = C3 // 3, gN // g
    hd = C // heads
    q, k, v = qkv_g.reshape(nG, gN, 3, heads, hd).permute(2, 0, 3, 1, 4)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
    key = torch.arange(N, device=qkv_g.device)
    a = torch.arange(win, device=qkv_g.device)[:, None]
    sel = torch.cat([key // win == a, key % win == a]).float()  # (2 win, N)
    bias = torch.matmul(bhw.float(), sel).repeat(1, 1, 1, g)    # (nG, heads, gN, gN)
    window = torch.arange(gN, device=qkv_g.device) // N
    s = torch.where(window[:, None] == window[None, :], s + bias, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p.to(qkv_g.dtype).float(), v.float())
    return out.permute(0, 2, 1, 3).reshape(nG, gN, C).to(qkv_g.dtype)


def diag_attn_plain(qkv_w, bh, bw, g: int):
    """T1's plain version: diag_attn's layout work and _diag_kernel's math;
    qkv_w [nW, N, 3C] (bias in), bh, bw [nW, heads, N, win] -> [nW, N, C]."""
    nW, N, C3 = qkv_w.shape
    return _diag_plain(*_fold(qkv_w, bh, bw, g), g).reshape(nW, N, C3 // 3)


def diag_attn(qkv_w, bh, bw, g: int):
    """T1 (diag_attn): K11's function with g windows folded into the rows of
    one masked product per head. qkv_w [nW, win*win, 3C], bh, bw [nW,
    heads, win*win, win] -> [nW, win*win, C]; g divides nW."""
    nW, N, C3 = qkv_w.shape
    qkv_g, bhw = _fold(qkv_w, bh, bw, g)
    if _build.on_cpu(qkv_w):
        return _diag_plain(qkv_g, bhw, g).reshape(nW, N, C3 // 3)
    heads, win = bh.shape[1], bh.shape[-1]
    if N != win * win:
        raise ValueError(f"diag_attn: {N} tokens are not a {win}x{win} window")
    if C3 % (3 * heads):
        raise ValueError(f"diag_attn: {C3 // 3} channels do not split into {heads} heads")
    _build.require_head_dim(C3 // 3 // heads, "diag_attn")
    bf = torch.bfloat16
    _build.require(qkv_g, "qkv", bf)
    _build.require(bhw, "bh|bw", bf)
    out = torch.empty((nW // g, g * N, C3 // 3), dtype=bf, device=qkv_w.device)
    _build.check(_build.kernels().samroad_diag_attention(
        qkv_g.data_ptr(), bhw.data_ptr(), out.data_ptr(), nW // g, g, C3 // 3, heads, win,
        _build.stream_of(qkv_w)), "diag_attn")
    _build.launches["diag_attn"] += 1
    return out.reshape(nW, N, C3 // 3)


def main(groups=GROUPS, device: str = "cuda", *, windows: int = 32 * 9, win: int = 14,
         dim: int = 768, heads: int = 12, iters: int = 10, rounds: int = 4) -> dict:
    """Returns and prints the results dict. The geometry arguments exist so
    that a test can run the tool small (`windows` is B x 9 at grid 32)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to run the plain versions")
    DT = torch.bfloat16
    N = win * win
    rng = np.random.default_rng(0)

    def arr(shape):
        return torch.from_numpy((rng.normal(size=shape) * 0.3).astype(np.float32)).to(dev, DT)

    qkv, bh, bw = arr((windows, N, 3 * dim)), arr((windows, heads, N, win)), arr(
        (windows, heads, N, win))

    results, runners = {}, []
    with torch.no_grad():
        ref = window_attention_rows(qkv, bh, bw, win, heads).float()
        ref_abs = float(ref.abs().sum())

        def check_and_stage(label, fn):
            rel = float((fn().float() - ref).abs().sum()) / max(ref_abs, 1e-9)
            results[label + "_reldiff"] = round(rel, 8)
            if rel > 1e-2:
                results[label + "_ms"] = f"WRONG (rel {rel:.2e})"
                print(f"# {label}: WRONG rel {rel:.2e}", flush=True)
                return
            runners.append((label, fn))
            print(f"# {label}: ran, rel {rel:.2e}", flush=True)

        check_and_stage("prod_rows", lambda: window_attention_rows(qkv, bh, bw, win, heads))
        for g in groups:
            check_and_stage(f"diag_g{g}", lambda g=g: diag_attn(qkv, bh, bw, g))
        for _ in range(rounds):
            for label, fn in runners:
                ms = ms_per_call(fn, iters, dev)
                results.setdefault(label + "_all", []).append(round(ms, 2))
    for label, _ in runners:
        results[label + "_ms"] = min(results[label + "_all"])
    print(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("groups", nargs="?", default=",".join(map(str, GROUPS)),
                    help="comma-separated windows per fold")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    a = ap.parse_args()
    main(tuple(int(x) for x in a.groups.split(",")), a.device)
