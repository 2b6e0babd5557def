"""Attention kernels (counterpart of sam_road_tpu/ops/attention.py):

K3 attention_relpos_rows: global attention with decomposed rel-pos bias
rows, the fused encoder's global blocks.
K5 fused_attention: softmax(q.k^T).v with the rel-pos folded into the
contraction (models/vit.py::fold_rel_pos_qk), every attention of the eager
encoder with use_flash on (the training path). Differentiable: its backward
recomputes in plain PyTorch, as the JAX custom_vjp recomputes in XLA.
K6 attention_relpos_rows_d: K3 under an autograd.Function (the fused
training encoder, FUSED_ENCODER_TRAIN) replacing the JAX custom_vjp of that
name (attention.py:241-261); its backward recomputes
attention_relpos_rows_plain under autograd (_build.recompute_vjp) and
launches no custom kernel. On a CUDA tensor the forward counts under the
kernel's name and the wrapper's.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
hand-written kernel (csrc/relpos_attention.cu, csrc/flash_attention.cu) or
raises.

Source notes. K3 replaces attention.py::attention_relpos_rows
(_relpos_rows_kernel), which holds a whole (image, head)'s 1024 x 1024
scores in VMEM. On the H100 it is compute-bound (268 MFLOP per (image,
head) against 0.5 MB of q/k/v) and shared memory cannot hold the scores,
so the kernel is a flash-attention loop: one block per (image x head,
64-query tile), 64-key tiles, fp32 online softmax, the bias rows spread as
bh[n, m // W] + bw[n, m % W] onto each key tile. K5 replaces
attention.py::fused_attention (_flash_forward: the whole-N _flash_kernel and
the kv-tiled _blocked_kernel) with the same loop over a runtime contraction
width D = head_dim + H + W; it tiles every N, so the XLA fallback for an N
the TPU kernel cannot tile has no counterpart.
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


class _AttentionRelposRowsD(torch.autograd.Function):
    """K6 attention_relpos_rows_d: K3 forward, saving (q, k, v, bh, bw);
    backward = autograd of attention_relpos_rows_plain recomputed on
    them."""

    @staticmethod
    def forward(ctx, q, k, v, bh, bw, hw):
        ctx.save_for_backward(q, k, v, bh, bw)
        ctx.hw = hw
        out = attention_relpos_rows(q, k, v, bh, bw, hw)
        if not _build.on_cpu(q):
            _build.launches["attention_relpos_rows_d"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        return _build.recompute_vjp(ctx, attention_relpos_rows_plain, g, ctx.hw) + (None,)


def attention_relpos_rows_d(q, k, v, bh, bw, hw):
    """K6: differentiable attention_relpos_rows (the global blocks of the
    training encoder)."""
    return _AttentionRelposRowsD.apply(q, k, v, bh, bw, hw)


def fused_attention_plain(q, k, v):
    """Follows sam_road_tpu/ops/attention.py::_flash_forward's math:
    s = q.k^T in fp32, softmax, p cast to v.dtype for p.v. q carries the
    scale and the folded rel-pos columns."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def _flash_forward(q, k, v):
    if _build.on_cpu(q):
        return fused_attention_plain(q, k, v)
    B, H, N, D = q.shape
    dv = v.shape[-1]
    if D % 2 or dv % 16 or dv > 128:
        raise ValueError(f"flash attention kernel needs an even D and a value width that is "
                         f"a multiple of 16 up to 128, got D={D} dv={dv}")
    bf = torch.bfloat16
    _build.require(q, "q", bf)
    _build.require(k, "k", bf, q.shape)
    _build.require(v, "v", bf, (B, H, N, dv))
    out = torch.empty((B, H, N, dv), dtype=bf, device=q.device)
    lib = _build.kernels()
    _build.check(lib.samroad_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, N, D, dv,
        _build.stream_of(q)), "fused_attention")
    _build.launches["fused_attention"] += 1
    return out


class _FusedAttention(torch.autograd.Function):
    """K5 forward; backward recomputes in plain PyTorch, line for line as
    sam_road_tpu/ops/attention.py::_bwd: fp32 s and p, then
    dv = p^T g, dp = g v^T, ds = p (dp - sum(dp p)), dq = ds k, dk = ds^T q,
    each cast back to its input's dtype."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _flash_forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        p = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)), dim=-1)
        g32 = g.float()
        dv = torch.matmul(p.transpose(-1, -2), g32)
        dp = torch.matmul(g32, v.float().transpose(-1, -2))
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        del p, dp
        dq = torch.matmul(ds, k.float())
        dk = torch.matmul(ds.transpose(-1, -2), q.float())
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def fused_attention(q, k, v):
    """K5. q, k [B, H, N, D] (q scaled, rel-pos folded into D), v [B, H, N,
    dv]; on CUDA all bf16 and contiguous. Returns [B, H, N, dv] in v.dtype."""
    return _FusedAttention.apply(q, k, v)
