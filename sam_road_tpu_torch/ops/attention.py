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
hand-written kernel (csrc/relpos_attention.cu) or raises.

Source notes. K3 replaces attention.py::attention_relpos_rows
(_relpos_rows_kernel), which holds a whole (image, head)'s 1024 x 1024
scores in VMEM. On the H100 it is bound by operations (268 MFLOP per
(image, head) against 0.5 MB of q/k/v; 0.104 ms for the bench shape at the
bf16 tensor peak) and shared memory cannot hold the scores, so the kernel is
a flash-attention loop on Hopper's warpgroup product (wgmma, the only route
to that rate): one block per (image x head, 128-query tile), two
warpgroups of 64 rows; q fragments, scores, the online softmax and the
output accumulator all in registers (both products take their A operand
from registers); 64-key k / v tiles in a 3-stage cp.async ring in wgmma's
no-swizzle layout, which takes head_dim 80's 160-byte rows too; the bias
rows staged once as fp32 in shared memory (98 KB a block at head_dim 64).
Instances at head_dim 64 and 80 (vit_h's global blocks: 256 tokens at 256
px); the grid's width must be a multiple of 8 (the bias walks 8 keys of one
grid row an n8 tile). K5 replaces attention.py::fused_attention
(_flash_forward: the whole-N _flash_kernel and the kv-tiled _blocked_kernel)
with a mode of K3's loop (MODE_FOLDED): no bias rows, scale 1, the
contraction width D = head_dim + H + W a template parameter of its own
beside the value width, instantiated at (D, dv) = FOLDED_INSTANCES (a
smaller D % 8 == 0 is zero-filled to its instance; models/vit.py::
fold_rel_pos_qk pads to a multiple of 16, so rows stay 16-byte copies), and
ragged N (the windows' 196 tokens) masked by selects; it tiles every N, so
the XLA fallback for an N the TPU kernel cannot tile has no counterpart.
The JAX kernel takes any dtype; on fp32 inputs K5 launches a kernel of its
own (csrc/folded_attention_f32.cu: the same instances, each product as
three TF32 products on the tensor cores (wgmma), which keeps fp32's
accuracy; counted as fused_attention_f32), and any other dtype raises.
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
    if N != H * W or N % 64 or W % 8:
        raise ValueError(f"relpos attention kernel needs N == H*W, N % 64 == 0 and W % 8 == 0, "
                         f"got N={N} hw={hw}")
    _build.require_head_dim(D, "attention_relpos_rows")
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
        out.data_ptr(), B * nH, N, H, W, D, _build.stream_of(q)),
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


# K5's instances in csrc/relpos_attention.cu, (contraction width, value
# width): ViT-B / vit_l's windows (D 92) and 16 x 16 grids (96), the 32 x 32
# (128) and 64 x 64 (192) grids, vit_h's windows (108) and 16 x 16 grid
# (112), vit_t's windows (head_dim 32: D 60)
FOLDED_INSTANCES = ((96, 64), (128, 64), (192, 64), (112, 80), (64, 32))


def folded_instance(D: int, dv: int) -> tuple:
    """The (DQK, HD) instance that runs K5 at contraction width D and value
    width dv: the narrowest DQK >= D at HD == dv. Raise ValueError when D is
    no multiple of 8 (the kernel copies 16-byte rows) or no instance fits."""
    if D > 0 and D % 8 == 0:
        for dqk, hd in FOLDED_INSTANCES:
            if hd == dv and D <= dqk:
                return dqk, hd
    raise ValueError(f"fused_attention kernel has instances (D, dv) in {FOLDED_INSTANCES} "
                     f"(a smaller D that is a multiple of 8 is zero-filled to its instance), "
                     f"got D={D} dv={dv}")


# K5's kernels by dtype: (C entry point, launch count name). bf16 is
# relpos_attention.cu's MODE_FOLDED (wgmma), fp32 folded_attention_f32.cu
# (each operand split into two TF32 halves, three TF32 products for each
# fp32 one: a single TF32 product would not meet an fp32 tolerance)
FOLDED_KERNELS = {torch.bfloat16: ("samroad_folded_attention", "fused_attention"),
                  torch.float32: ("samroad_folded_attention_f32", "fused_attention_f32")}


def _flash_forward(q, k, v):
    if _build.on_cpu(q):
        return fused_attention_plain(q, k, v)
    B, H, N, D = q.shape
    dv = v.shape[-1]
    folded_instance(D, dv)
    if q.dtype not in FOLDED_KERNELS:
        raise TypeError(f"fused_attention kernel takes bf16 or fp32 q, k and v on CUDA, "
                        f"got {q.dtype}")
    entry, name = FOLDED_KERNELS[q.dtype]
    _build.require(q, "q", q.dtype)
    _build.require(k, "k", q.dtype, q.shape)
    _build.require(v, "v", q.dtype, (B, H, N, dv))
    out = torch.empty((B, H, N, dv), dtype=q.dtype, device=q.device)
    _build.check(getattr(_build.kernels(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, N, D, dv,
        _build.stream_of(q)), name)
    _build.launches[name] += 1
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
    dv]; on CUDA all bf16 or all fp32 (each dtype its own kernel, counted
    under its own name: fused_attention, fused_attention_f32) and
    contiguous, (D, dv) within folded_instance's set; any other dtype
    raises TypeError. Returns [B, H, N, dv] in v.dtype."""
    return _FusedAttention.apply(q, k, v)
