"""Fused-kernel encoder forward, the engine's phase-1 encoder (counterpart
of sam_road_tpu/models/fast_encoder.py in its default configuration).

A functional re-statement of ImageEncoderViT.forward over the same module
that routes every block through the four kernels:
  K1 ops.fused_ln.ln_dense                       LN1 + qkv (12 per forward)
  K2 ops.fused_block.window_attention_rows_grid  windowed attention (8)
  K3 ops.attention.attention_relpos_rows         global attention (4)
  K4 ops.fused_ln.proj_ln_mlp_residual           block tail (12)
On CPU tensors each takes its plain PyTorch version. The patch embedding,
the rel-pos bias-row einsums and the neck run as plain torch ops, as they
ran in XLA outside the Pallas kernels.

Windowed blocks keep the reference's bias-after-pad rule: qkv is computed
without bias on the real tokens, zero-padded to the window grid, and the
attention kernel adds the bias to every token, so each pad token equals
`bias` = qkv(0), SAM's zero padding of the norm1 output. The bias rows
bh = q.Rh, bw = q.Rw are precomputed for all windows and heads with the
bias's share (bias_q . R) added analytically. Global blocks use K3 at every
grid size: K3 tiles the keys, so the JAX package's switch to K5 past ~1225
tokens (the 1024 px config) has no counterpart here, and the JAX A/B
switches PAD_FREE, XLA_TAIL and WIN_* keep their defaults and are not
ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sam_road_tpu_torch.models.vit import ImageEncoderViT, rel_pos_table
from sam_road_tpu_torch.ops.attention import attention_relpos_rows
from sam_road_tpu_torch.ops.fused_block import window_attention_rows_grid
from sam_road_tpu_torch.ops.fused_ln import ln_dense, proj_ln_mlp_residual


def _w(t, dt):
    return t.to(dt).contiguous()


def _tail(x, out, blk, dt):
    """K4 over the block's proj / norm2 / MLP weights; x, out [B, H, W, C]."""
    B, H, W, C = x.shape
    attn, mlp = blk.attn, blk.mlp
    return proj_ln_mlp_residual(
        x.reshape(B * H * W, C), out.reshape(B * H * W, C).contiguous(),
        _w(attn.proj.weight, dt), _w(attn.proj.bias, dt),
        _w(blk.norm2.weight, dt), _w(blk.norm2.bias, dt),
        _w(mlp.lin1.weight, dt), _w(mlp.lin1.bias, dt),
        _w(mlp.lin2.weight, dt), _w(mlp.lin2.bias, dt),
    ).reshape(B, H, W, C)


def _windowed_block(x, blk, num_heads: int, ws: int):
    B, H, W, C = x.shape
    dt = x.dtype
    attn = blk.attn
    qkv_nb = ln_dense(x.reshape(B * H * W, C), _w(blk.norm1.weight, dt),
                      _w(blk.norm1.bias, dt), _w(attn.qkv.weight, dt), None)
    pad_h, pad_w = (ws - H % ws) % ws, (ws - W % ws) % ws
    qkv_p = F.pad(qkv_nb.reshape(B, H, W, 3 * C), (0, 0, 0, pad_w, 0, pad_h))
    nI, nJ = (H + pad_h) // ws, (W + pad_w) // ws
    hd = C // num_heads
    Rh = rel_pos_table(ws, attn.rel_pos_h).to(dt)  # (ws, ws, hd)
    Rw = rel_pos_table(ws, attn.rel_pos_w).to(dt)
    q_p = qkv_p[..., :C].reshape(B, nI, ws, nJ, ws, num_heads, hd)
    bias_q = attn.qkv.bias[:C].reshape(num_heads, hd).to(dt)
    bh = torch.einsum("bIiJjhc,iac->bIJhija", q_p, Rh)
    bw = torch.einsum("bIiJjhc,jac->bIJhija", q_p, Rw)
    bh = bh + torch.einsum("hc,iac->hia", bias_q, Rh)[None, None, None, :, :, None, :]
    bw = bw + torch.einsum("hc,jac->hja", bias_q, Rw)[None, None, None, :, None, :, :]
    N = ws * ws
    bh = bh.reshape(B, nI, nJ, num_heads, N, ws).contiguous()
    bw = bw.reshape(B, nI, nJ, num_heads, N, ws).contiguous()
    out_p = window_attention_rows_grid(qkv_p, _w(attn.qkv.bias, dt), bh, bw,
                                       ws, num_heads)
    return _tail(x, out_p[:, :H, :W, :], blk, dt)


def _global_block(x, blk, num_heads: int):
    B, H, W, C = x.shape
    dt = x.dtype
    attn = blk.attn
    hd = C // num_heads
    N = H * W
    qkv = ln_dense(x.reshape(B * N, C), _w(blk.norm1.weight, dt),
                   _w(blk.norm1.bias, dt), _w(attn.qkv.weight, dt),
                   _w(attn.qkv.bias, dt))
    q, k, v = qkv.reshape(B, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    Rh = rel_pos_table(H, attn.rel_pos_h).to(dt)
    Rw = rel_pos_table(W, attn.rel_pos_w).to(dt)
    r_q = q.reshape(B, num_heads, H, W, hd)
    # bias rows from the UNSCALED q; the kernel takes q pre-scaled
    bh = torch.einsum("bnhwc,hkc->bnhwk", r_q, Rh).reshape(B, num_heads, N, H)
    bw = torch.einsum("bnhwc,wkc->bnhwk", r_q, Rw).reshape(B, num_heads, N, W)
    out = attention_relpos_rows(
        (q * hd ** -0.5).contiguous(), k.contiguous(), v.contiguous(),
        bh.contiguous(), bw.contiguous(), (H, W))
    return _tail(x, out.permute(0, 2, 1, 3).reshape(B, H, W, C), blk, dt)


@torch.no_grad()
def encoder_forward_fused(encoder: ImageEncoderViT, x):
    """x [B, img, img, 3] normalised NHWC -> [B, img/16, img/16, 256] in
    encoder.dtype, through K1-K4."""
    x = encoder.embed(x)
    nh = encoder.num_heads
    for i, blk in enumerate(encoder.blocks):
        if i in encoder.global_attn_indexes:
            x = _global_block(x, blk, nh)
        else:
            x = _windowed_block(x, blk, nh, encoder.window_size)
    return encoder.apply_neck(x)
