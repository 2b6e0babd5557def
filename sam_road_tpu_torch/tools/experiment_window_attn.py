"""Windowed-attention variants timed on the card (B = 32 patches, ViT-B
geometry: 3456 (window, head) pairs of 196 tokens, the rel-pos folded into
a q/k width of 64 + 2 x 14 = 92, values 64 wide): the counterpart of the
repository's tools/experiment_window_attn.py, on the same default_rng(0)
inputs (x 0.1), with its JSON keys.

Variants (each `<label>_ms`, and `<label>_l1`, the L1 norm of its output):
  xla         the plain PyTorch formulation: einsum, fp32 softmax, einsum
  kernel1     T2, window_attn_kernel1: one (window, head) a block
  kernel_g4   T3, window_attn_grouped: 4 (window, head) pairs a block
  kernel_g16  T3 at 16

T2 replaces the tool's pallas1 (kern1) and T3 its pallasG (kernG): one mode
of the per-window body in csrc/window_attention.cu, s = q.k^T unscaled in
fp32, p = exp(s - max) rounded to bf16 unnormalised, p.v in fp32, then the
division by the fp32 row sum. The 92 q/k columns are zero-padded to 96 in
shared memory and load 8 bytes at a time (a 184-byte row is only 8-byte
aligned). T3's G pairs a block loop over T2's code, so every G gives T2's
output to the bit. Like K11, bound by latency and shared memory: 423 MB of
HBM traffic (0.126 ms at 3.35 TB/s) against 41 GFLOP.

Timing: CUDA events around `iters` calls, the least per-call time of `reps`
runs (host clock with --device cpu, where the kernels' wrappers take their
plain versions); the JAX tool's lax.scan loop has no counterpart. Every
variant runs 1 + reps * iters times, so each kernel's launches are exact.

    python -m sam_road_tpu_torch.tools.experiment_window_attn [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from sam_road_tpu_torch.ops import _build
from sam_road_tpu_torch.utils.profiling import ms_per_call

GROUPS = (4, 16)
PAIRS = {  # each kernel variant -> the plain variant of the same function
    "kernel1": "xla", "kernel_g4": "xla", "kernel_g16": "xla"}


def window_attn_plain(q, k, v):
    """Follows kern1 (tools/experiment_window_attn.py:66-73): s = q.k^T in
    fp32 (no scale), p = exp(s - max) unnormalised, o = (p in v.dtype) . v
    in fp32, divided by the fp32 row sum of p. q, k [BH, N, D], v [BH, N,
    dv] -> [BH, N, dv] in v.dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return (o / p.sum(dim=-1, keepdim=True)).to(v.dtype)


def window_attn_grouped_plain(q, k, v, G: int):
    """Follows kernG (:96-105): G windows a program, each as kern1."""
    BH = q.shape[0]
    if BH % G:
        raise ValueError(f"{G} windows a program do not divide {BH}")
    out = window_attn_plain(*(t.reshape(BH // G, G, *t.shape[1:]) for t in (q, k, v)))
    return out.reshape(BH, *out.shape[2:])


def _folded(q, k, v, G: int, name: str):
    """Launch T2 / T3 (csrc/window_attention.cu, samroad_window_attn_folded)."""
    BH, N, D = q.shape
    win = math.isqrt(N)
    if win * win != N:
        raise ValueError(f"{name}: {N} tokens are not a square window")
    if D > 96 or D % 4 or v.shape[-1] != 64 or BH % G:
        raise ValueError(f"{name} kernel needs a q/k width that is a multiple of 4 up to 96, "
                         f"values 64 wide and G dividing {BH}; got D={D} dv={v.shape[-1]} G={G}")
    bf = torch.bfloat16
    _build.require(q, "q", bf)
    _build.require(k, "k", bf, q.shape)
    _build.require(v, "v", bf, (BH, N, 64))
    out = torch.empty_like(v)
    _build.check(_build.kernels().samroad_window_attn_folded(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, D, win, G,
        _build.stream_of(q)), name)
    _build.launches[name] += 1
    return out


def window_attn_kernel1(q, k, v):
    """T2 (pallas1): q, k [BH, N, D] (rel-pos folded in, D <= 96), v [BH,
    N, 64] -> [BH, N, 64], one (window, head) a block."""
    if _build.on_cpu(q):
        return window_attn_plain(q, k, v)
    return _folded(q, k, v, 1, "window_attn_kernel1")


def window_attn_grouped(q, k, v, G: int):
    """T3 (pallasG): T2 with G (window, head) pairs a block; G divides BH."""
    if _build.on_cpu(q):
        return window_attn_grouped_plain(q, k, v, G)
    return _folded(q, k, v, G, "window_attn_grouped")


def xla_attn(q, k, v):
    """The tool's `xla` variant in plain PyTorch: einsum with fp32 scores,
    fp32 softmax cast to v.dtype, einsum."""
    s = torch.einsum("bnd,bmd->bnm", q.float(), k.float())
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bnm,bmd->bnd", p, v)


def main(device: str = "cuda", *, batch: int = 32, heads: int = 12, win: int = 14,
         windows: int = 9, hd: int = 64, iters: int = 30, reps: int = 3) -> dict:
    """Returns and prints {label_ms, label_l1}. The geometry arguments exist
    so that a test can run the tool small; `windows` is windows per patch
    (9 at grid 32, window 14)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to run the plain versions")
    DT = torch.bfloat16
    N, BH, D = win * win, batch * windows * heads, hd + 2 * win
    rng = np.random.default_rng(0)

    def arr(shape):
        return torch.from_numpy((rng.normal(size=shape) * 0.1).astype(np.float32)).to(dev, DT)

    q, k, v = arr((BH, N, D)), arr((BH, N, D)), arr((BH, N, hd))

    variants = {"xla": xla_attn, "kernel1": window_attn_kernel1}
    for G in GROUPS:
        variants[f"kernel_g{G}"] = lambda q, k, v, G=G: window_attn_grouped(q, k, v, G)
    results = {}
    with torch.no_grad():
        for label, fn in variants.items():
            results[label + "_l1"] = float(fn(q, k, v).float().abs().sum())
            results[label + "_ms"] = round(
                min(ms_per_call(lambda: fn(q, k, v), iters, dev) for _ in range(reps)), 3)
            print(f"# {label}: {results[label + '_ms']} ms", flush=True)
    print(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    main(ap.parse_args().device)
