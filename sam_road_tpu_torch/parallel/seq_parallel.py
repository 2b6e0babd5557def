"""Sequence-parallel (token-row sharded) encoder forward over a mesh
(counterpart of sam_road_tpu/parallel/seq_parallel.py).

The token grid of a batch of patches is cut into n row bands, band d on
mesh.devices[d]. One process drives every shard; each collective of the JAX
body becomes copies onto the receiving device and a torch.cat in shard
order:

  patch embed, LN, MLP   local to a band (the 16 x 16 stride-16 patch
                         embedding is local to its pixel rows);
  windowed blocks        every shard gathers the post-LN grid, computes its
                         1/n of the 14 x 14 windows (padded up to a multiple
                         of n), and gathers the window outputs back;
  global blocks          q stays local; k and v are gathered, and the rel-pos
                         bias folds into q~ / k~ with the shard's absolute
                         first row (models/vit.py::fold_rel_pos_qk, row0);
  neck                   once, on the gathered grid on the first shard's
                         device (JAX computes it on every device; here one
                         process would repeat the same work n times).

Attention is plain torch, as it is plain XLA in JAX: scores in fp32 from the
compute-dtype operands (JAX's preferred_element_type=float32), softmax in
fp32, cast to the compute dtype before p.v. No kernel runs on this path.
The scores are formed a few images at a time so that they stay under
_SCORE_BYTES. The JAX body's numerics hold per token: in fp32 it matches
the eager encoder to ~2e-5. LoRA adapters are not read by the JAX body;
here an encoder with them raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sam_road_tpu_torch.models.vit import (
    ENCODER_SPECS,
    fold_rel_pos_qk,
    layer_norm,
    linear,
    rel_pos_table,
)
from sam_road_tpu_torch.parallel.mesh import Mesh, replicate

_SCORE_BYTES = 2 ** 31  # fp32 scores formed at once by _attn_grid


def _attn_grid(q, k, v, attn, hw, num_heads, dtype, row0=0):
    """Exact SAM attention for row-aligned queries over an (H, W) grid. q
    [G, Nq, C] the queries of grid rows [row0, row0 + Nq / W); k, v [G, N,
    C] the full grid. Returns [G, Nq, C] (heads merged, before proj)."""
    H, W = hw
    G, Nq, C = q.shape
    N = k.shape[1]
    hd = C // num_heads
    qh = q.reshape(G, Nq, num_heads, hd).transpose(1, 2)
    kh = k.reshape(G, N, num_heads, hd).transpose(1, 2)
    vh = v.reshape(G, N, num_heads, hd).transpose(1, 2)
    Rh = rel_pos_table(H, attn.rel_pos_h).to(dtype)
    Rw = rel_pos_table(W, attn.rel_pos_w).to(dtype)
    q_aug, k_aug = fold_rel_pos_qk(qh, kh, Rh, Rw, (H, W), hd ** -0.5, row0=row0)
    step = max(1, _SCORE_BYTES // (num_heads * Nq * N * 4))
    outs = []
    for g in range(0, G, step):
        scores = q_aug[g:g + step].float() @ k_aug[g:g + step].float().transpose(-1, -2)
        outs.append(torch.softmax(scores, dim=-1).to(dtype) @ vh[g:g + step])
    return torch.cat(outs).transpose(1, 2).reshape(G, Nq, C)


def _window_attn(xw, attn, num_heads, ws, dtype):
    """Windowed attention on [Gw, ws * ws, C] windows of the post-LN grid."""
    q, k, v = linear(xw, attn.qkv).chunk(3, dim=-1)
    out = _attn_grid(q, k, v, attn, (ws, ws), num_heads, dtype)
    return linear(out, attn.proj)


def _mlp(x, blk):
    return x + blk.mlp(layer_norm(x, blk.norm2))


def make_sp_encoder_body(sam_version: str = "vit_b", img_size: int = 1024,
                         window_size: int = 14, dtype=torch.float32, n: int = 1):
    """The token-sharded encoder as `body(encoders, x_bands)`: encoders[d]
    the ImageEncoderViT on shard d's device, x_bands[d] that shard's pixel
    rows [B, Hpx / n, W, 3] of the normalised image. Returns the [B, h, w,
    256] feature map on the first shard's device. The engine calls it in
    its SP_SHARDS mode; encoder_forward_sp wraps it. JAX's `axis` argument
    has no counterpart: a Mesh has the one axis "dp"."""
    spec = ENCODER_SPECS[sam_version]
    depth, num_heads = spec["depth"], spec["num_heads"]
    global_idx = set(spec["global_attn_indexes"])
    grid = img_size // 16
    if grid % n:
        raise ValueError(f"token grid rows {grid} must divide over {n} devices")
    rows_l = grid // n
    ws = window_size
    pad_h = (ws - grid % ws) % ws
    Hp = grid + pad_h
    n_wrows = Hp // ws
    n_win = n_wrows * n_wrows
    win_pad = (n - n_win % n) % n
    wpd = (n_win + win_pad) // n  # windows per shard

    def body(encoders, x_bands):
        if len(encoders) != n or len(x_bands) != n:
            raise ValueError(f"the body takes {n} encoders and bands, got "
                             f"{len(encoders)} and {len(x_bands)}")
        if any(e.lora_rank for e in encoders):
            raise ValueError("the sequence-parallel encoder does not read LoRA adapters")
        devs = [b.device for b in x_bands]

        def gather(ts, d, dim):  # all_gather(tiled) as shard d receives it
            return torch.cat([t.to(devs[d]) for t in ts], dim=dim)

        hs = []
        for d, (enc, xb) in enumerate(zip(encoders, x_bands)):
            h = enc.patch_embed(xb.to(dtype))
            hs.append(h + enc.pos_embed[:, d * rows_l:(d + 1) * rows_l].to(dtype))
        B, _, W, C = hs[0].shape
        for i in range(depth):
            blks = [enc.blocks[i] for enc in encoders]
            lns = [layer_norm(h, blk.norm1) for h, blk in zip(hs, blks)]
            if i in global_idx:
                # gathered-KV global attention: local q rows against all keys
                qkv = [linear(ln.reshape(B, rows_l * W, C), blk.attn.qkv).chunk(3, dim=-1)
                       for ln, blk in zip(lns, blks)]
                for d, blk in enumerate(blks):
                    k_all = gather([t[1] for t in qkv], d, 1)
                    v_all = gather([t[2] for t in qkv], d, 1)
                    out = _attn_grid(qkv[d][0], k_all, v_all, blk.attn, (grid, grid),
                                     num_heads, dtype, row0=d * rows_l)
                    hs[d] = hs[d] + linear(out, blk.attn.proj).reshape(B, rows_l, W, C)
            else:
                # windowed attention: gather the post-LN grid, compute this
                # shard's slice of the windows, gather the outputs back
                outs = []
                for d, blk in enumerate(blks):
                    ln_all = F.pad(gather(lns, d, 1), (0, 0, 0, pad_h, 0, pad_h))
                    xw = ln_all.reshape(B, n_wrows, ws, n_wrows, ws, C)
                    xw = xw.permute(1, 3, 0, 2, 4, 5).reshape(n_win, B, ws * ws, C)
                    xw = F.pad(xw, (0, 0, 0, 0, 0, 0, 0, win_pad))
                    mine = xw[d * wpd:(d + 1) * wpd].reshape(wpd * B, ws * ws, C)
                    out = _window_attn(mine, blk.attn, num_heads, ws, dtype)
                    outs.append(out.reshape(wpd, B, ws * ws, C))
                for d in range(n):
                    full = gather(outs, d, 0)[:n_win].reshape(n_wrows, n_wrows, B, ws, ws, C)
                    full = full.permute(2, 0, 3, 1, 4, 5).reshape(B, Hp, Hp, C)[:, :grid, :grid]
                    hs[d] = hs[d] + full[:, d * rows_l:(d + 1) * rows_l]
            hs = [_mlp(h, blk) for h, blk in zip(hs, blks)]
        # the neck on the gathered grid, once, on the first shard's device
        return encoders[0].apply_neck(gather(hs, 0, 1))

    return body


def encoder_forward_sp(encoder, x, mesh: Mesh, sam_version: str = "vit_b", img_size: int = 1024,
                       window_size: int = 14, dtype=torch.float32):
    """Token-sharded forward of `encoder` (an ImageEncoderViT) over the
    mesh. x [B, H, W, 3] normalised image on any device; returns the [B, h,
    w, 256] feature map that ImageEncoderViT computes, on
    mesh.devices[0]. Raises unless the grid rows (img_size / 16) divide
    over the mesh."""
    n = mesh.size
    body = make_sp_encoder_body(sam_version=sam_version, img_size=img_size,
                                window_size=window_size, dtype=dtype, n=n)
    rows_px = x.shape[1] // n
    bands = [x[:, d * rows_px:(d + 1) * rows_px].to(dev) for d, dev in enumerate(mesh.devices)]
    return body(replicate(encoder, mesh), bands)
