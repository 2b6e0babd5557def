"""K3 attention_relpos_rows: global attention with decomposed rel-pos bias
rows (counterpart of sam_road_tpu/ops/attention.py::attention_relpos_rows).

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
hand-written kernel in csrc/relpos_attention.cu or raises.

Source note. Replaces attention.py::attention_relpos_rows
(_relpos_rows_kernel), which holds a whole (image, head)'s 1024 x 1024
scores in VMEM. On the H100 it is compute-bound (268 MFLOP per (image,
head) against 0.5 MB of q/k/v) and shared memory cannot hold the scores,
so the kernel is a flash-attention loop: one block per (image x head,
64-query tile), 64-key tiles, fp32 online softmax, the bias rows spread as
bh[n, m // W] + bw[n, m % W] onto each key tile.
"""

from __future__ import annotations

import torch

from sam_road_tpu_torch.ops import _build


def attention_relpos_rows_plain(q, k, v, bh, bw, hw):
    """Follows sam_road_tpu/ops/attention.py::_relpos_rows_ref:
    s = q.k^T + bh[n, m // W] + bw[n, m % W], fp32 softmax, p cast to
    v.dtype for p.v."""
    H, W = hw
    B, nH, N, _ = q.shape
    s = torch.matmul(q, k.transpose(-1, -2)).float().reshape(B, nH, N, H, W)
    s = s + bh.float()[..., None] + bw.float()[..., None, :]
    p = torch.softmax(s.reshape(B, nH, N, N), dim=-1)
    return torch.matmul(p.to(v.dtype), v).to(v.dtype)


def attention_relpos_rows(q, k, v, bh, bw, hw):
    """K3. q [B, nH, N, D] PRE-SCALED, k, v [B, nH, N, D]; bh [B, nH, N, H]
    = q.Rh and bw [B, nH, N, W] = q.Rw from the unscaled q; N == H * W.
    Returns [B, nH, N, D]."""
    if _build.on_cpu(q):
        return attention_relpos_rows_plain(q, k, v, bh, bw, hw)
    H, W = hw
    B, nH, N, D = q.shape
    if N != H * W or N % 64 or D != 64:
        raise ValueError(f"relpos attention kernel needs N == H*W, N % 64 == 0 "
                         f"and head_dim 64, got N={N} hw={hw} D={D}")
    bf = torch.bfloat16
    _build.require(q, "q", bf)
    _build.require(k, "k", bf, q.shape)
    _build.require(v, "v", bf, q.shape)
    _build.require(bh, "bh", bf, (B, nH, N, H))
    _build.require(bw, "bw", bf, (B, nH, N, W))
    out = torch.empty_like(q)
    lib = _build.kernels()
    _build.check(lib.samroad_relpos_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bh.data_ptr(), bw.data_ptr(),
        out.data_ptr(), B * nH, N, H, W, _build.stream_of(q)),
        "attention_relpos_rows")
    _build.launches["attention_relpos_rows"] += 1
    return out
