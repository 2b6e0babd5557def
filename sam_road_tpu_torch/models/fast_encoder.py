"""Fused-kernel encoder forward (counterpart of
sam_road_tpu/models/fast_encoder.py in its default configuration): the
engine's phase-1 encoder (FUSED_ENCODER) and, differentiable, the training
encoder (FUSED_ENCODER_TRAIN).

A functional re-statement of ImageEncoderViT.forward over the same module
that routes every block through the four kernels:
  K1 ops.fused_ln.ln_dense                       LN1 + qkv (12 per forward)
  K2 ops.fused_block.window_attention_rows_grid  windowed attention (8)
  K3 ops.attention.attention_relpos_rows         global attention (4)
  K4 ops.fused_ln.proj_ln_mlp_residual           block tail (12)
With differentiable=True each goes through its K6 wrapper (ln_dense_d,
ln_dense_bias_d, window_attention_rows_grid_d, attention_relpos_rows_d,
proj_ln_mlp_residual_d): the same kernels forward, a plain-PyTorch
recompute backward. The weight casts, the bias-row einsums, the pad, the
crop and the q/k/v permutes stay outside the wrappers, in autograd, so the
gradients reach the fp32 parameters (qkv.bias and the rel-pos tables also
through the bias rows). remat checkpoints each block
(torch.utils.checkpoint), as the JAX path's jax.checkpoint per block.
On CPU tensors each op takes its plain PyTorch version. The patch
embedding, the rel-pos bias-row einsums and the neck run as plain torch
ops, as they ran in XLA outside the Pallas kernels.

Windowed blocks keep the reference's bias-after-pad rule: qkv is computed
without bias on the real tokens, zero-padded to the window grid, and the
attention kernel adds the bias to every token, so each pad token equals
`bias` = qkv(0), SAM's zero padding of the norm1 output. The bias rows
bh = q.Rh, bw = q.Rw are precomputed for all windows and heads with the
bias's share (bias_q . R) added analytically. Global blocks use K3 at every
grid size: K3 tiles the keys, so the JAX package's switch to K5 past ~1225
tokens (the 1024 px config) has no counterpart here.

The JAX package's module switches, read at call time with its semantics,
change only the windowed blocks of the inference path (differentiable=False;
the training path and the global blocks ignore them):
  PAD_FREE        K7 ops.fused_ln.ln_dense_padded writes LN1 + qkv straight
                  into the window-padded grid (no F.pad pass), and K8
                  ops.fused_ln.proj_ln_mlp_residual_grid reads the attention
                  output from it (no crop copy): per forward 4 K1 + 8 K7 and
                  4 K4 + 8 K8;
  WIN_GROUP_BATCH K10, G images a block in window attention (G > 1 wins);
  WIN_ROLLED_ROWS K10, one block per window row.
Every mode is bit-equal to the default on the card. XLA_TAIL (plain XLA, no
kernel) is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from sam_road_tpu_torch.models.vit import ImageEncoderViT, rel_pos_table
from sam_road_tpu_torch.ops.attention import attention_relpos_rows, attention_relpos_rows_d
from sam_road_tpu_torch.ops.fused_block import (
    window_attention_rows_grid,
    window_attention_rows_grid_d,
)
from sam_road_tpu_torch.ops.fused_ln import (
    ln_dense,
    ln_dense_bias_d,
    ln_dense_d,
    ln_dense_padded,
    proj_ln_mlp_residual,
    proj_ln_mlp_residual_d,
    proj_ln_mlp_residual_grid,
)

# The JAX package's switches (sam_road_tpu/models/fast_encoder.py), with its
# names and defaults; set them as module attributes.
PAD_FREE = False
WIN_GROUP_BATCH = 1
WIN_ROLLED_ROWS = False


def _w(t, dt):
    return t.to(dt).contiguous()


def _ln_qkv(x2d, blk, dt, with_bias: bool, diff: bool):
    """K1 (K6 ln_dense_d / ln_dense_bias_d when diff) over norm1 and qkv."""
    args = (x2d, _w(blk.norm1.weight, dt), _w(blk.norm1.bias, dt), _w(blk.attn.qkv.weight, dt))
    bias = _w(blk.attn.qkv.bias, dt) if with_bias else None
    if not diff:
        return ln_dense(*args, bias)
    return ln_dense_bias_d(*args, bias) if with_bias else ln_dense_d(*args)


def _tail_weights(blk, dt):
    attn, mlp = blk.attn, blk.mlp
    return (_w(attn.proj.weight, dt), _w(attn.proj.bias, dt),
            _w(blk.norm2.weight, dt), _w(blk.norm2.bias, dt),
            _w(mlp.lin1.weight, dt), _w(mlp.lin1.bias, dt),
            _w(mlp.lin2.weight, dt), _w(mlp.lin2.bias, dt))


def _tail(x, out, blk, dt, diff: bool):
    """K4 (K6 proj_ln_mlp_residual_d when diff) over the block's proj /
    norm2 / MLP weights; x, out [B, H, W, C]."""
    B, H, W, C = x.shape
    tail = proj_ln_mlp_residual_d if diff else proj_ln_mlp_residual
    return tail(x.reshape(B * H * W, C), out.reshape(B * H * W, C).contiguous(),
                *_tail_weights(blk, dt)).reshape(B, H, W, C)


def _bias_rows(qkv_p, attn, num_heads: int, ws: int):
    """bh = q.Rh, bw = q.Rw [B, nI, nJ, heads, ws*ws, ws] for every window
    and head of the bias-free padded qkv grid [B, Hp, Wp, 3C], with the qkv
    bias's share bias_q.R added analytically."""
    B, Hp, Wp, C3 = qkv_p.shape
    C, dt = C3 // 3, qkv_p.dtype
    nI, nJ = Hp // ws, Wp // ws
    hd = C // num_heads
    Rh = rel_pos_table(ws, attn.rel_pos_h).to(dt)  # (ws, ws, hd)
    Rw = rel_pos_table(ws, attn.rel_pos_w).to(dt)
    q_p = qkv_p[..., :C].reshape(B, nI, ws, nJ, ws, num_heads, hd)
    bias_q = attn.qkv.bias[:C].reshape(num_heads, hd).to(dt)
    bh = torch.einsum("bIiJjhc,iac->bIJhija", q_p, Rh)
    bw = torch.einsum("bIiJjhc,jac->bIJhija", q_p, Rw)
    bh = bh + torch.einsum("hc,iac->hia", bias_q, Rh)[None, None, None, :, :, None, :]
    bw = bw + torch.einsum("hc,jac->hja", bias_q, Rw)[None, None, None, :, None, :, :]
    rows = (B, nI, nJ, num_heads, ws * ws, ws)
    return bh.reshape(rows).contiguous(), bw.reshape(rows).contiguous()


def _windowed_block(x, blk, num_heads: int, ws: int, diff: bool = False):
    B, H, W, C = x.shape
    dt = x.dtype
    attn = blk.attn
    pad_free = PAD_FREE and not diff
    pad_h, pad_w = (ws - H % ws) % ws, (ws - W % ws) % ws
    if pad_free:
        x = x.contiguous()
        qkv_p = ln_dense_padded(x, _w(blk.norm1.weight, dt), _w(blk.norm1.bias, dt),
                                _w(attn.qkv.weight, dt), (pad_h, pad_w))
    else:
        qkv_nb = _ln_qkv(x.reshape(B * H * W, C), blk, dt, False, diff)
        qkv_p = F.pad(qkv_nb.reshape(B, H, W, 3 * C), (0, 0, 0, pad_w, 0, pad_h))
    bh, bw = _bias_rows(qkv_p, attn, num_heads, ws)
    if diff:
        out_p = window_attention_rows_grid_d(qkv_p, _w(attn.qkv.bias, dt), bh, bw, ws,
                                             num_heads)
    else:
        out_p = window_attention_rows_grid(qkv_p, _w(attn.qkv.bias, dt), bh, bw, ws, num_heads,
                                           rolled_rows=WIN_ROLLED_ROWS,
                                           group_batch=WIN_GROUP_BATCH)
    if pad_free:
        return proj_ln_mlp_residual_grid(x, out_p, *_tail_weights(blk, dt))
    return _tail(x, out_p[:, :H, :W, :], blk, dt, diff)


def _global_block(x, blk, num_heads: int, diff: bool = False):
    B, H, W, C = x.shape
    dt = x.dtype
    attn = blk.attn
    hd = C // num_heads
    N = H * W
    qkv = _ln_qkv(x.reshape(B * N, C), blk, dt, True, diff)
    q, k, v = qkv.reshape(B, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    Rh = rel_pos_table(H, attn.rel_pos_h).to(dt)
    Rw = rel_pos_table(W, attn.rel_pos_w).to(dt)
    r_q = q.reshape(B, num_heads, H, W, hd)
    # bias rows from the UNSCALED q; the kernel takes q pre-scaled
    bh = torch.einsum("bnhwc,hkc->bnhwk", r_q, Rh).reshape(B, num_heads, N, H)
    bw = torch.einsum("bnhwc,wkc->bnhwk", r_q, Rw).reshape(B, num_heads, N, W)
    global_attn = attention_relpos_rows_d if diff else attention_relpos_rows
    out = global_attn((q * hd ** -0.5).contiguous(), k.contiguous(), v.contiguous(),
                      bh.contiguous(), bw.contiguous(), (H, W))
    return _tail(x, out.permute(0, 2, 1, 3).reshape(B, H, W, C), blk, dt, diff)


def _forward(encoder: ImageEncoderViT, x, diff: bool, remat: bool):
    x = encoder.embed(x)
    nh = encoder.num_heads
    for i, blk in enumerate(encoder.blocks):
        if i in encoder.global_attn_indexes:
            args = (_global_block, x, blk, nh, diff)
        else:
            args = (_windowed_block, x, blk, nh, encoder.window_size, diff)
        x = checkpoint(*args, use_reentrant=False) if remat else args[0](*args[1:])
    return encoder.apply_neck(x)


def encoder_forward_fused(encoder: ImageEncoderViT, x, differentiable: bool = False,
                          remat: bool = False):
    """x [B, img, img, 3] normalised NHWC -> [B, img/16, img/16, 256] in
    encoder.dtype, through K1-K4. By default under torch.no_grad (the
    engine's phase 1). differentiable=True goes through the K6 wrappers
    with autograd on (the training step); remat then checkpoints each block,
    so only the block inputs persist to the backward pass."""
    if differentiable:
        return _forward(encoder, x, True, remat and torch.is_grad_enabled())
    with torch.no_grad():
        return _forward(encoder, x, False, False)
