"""SAM ViTDet image encoder as a PyTorch module (counterpart of
sam_road_tpu/models/vit.py).

Parameters carry SAM's torch names (patch_embed.proj, blocks.{i}.attn.qkv,
neck.{0..3}, ...), so a SAM state dict loads by name. `forward` is the
eager math: windowed and global attention with decomposed relative
position bias, zero padding of the norm1 output into windows, and a neck
with LayerNorm2d at eps 1e-6. With `use_flash` (FLASH_ATTENTION), every
attention over at least 128 tokens folds the bias into q and k
(fold_rel_pos_qk) and runs through K5, ops.attention.fused_attention, as
the JAX encoder's vit.py:181-196 does on the TPU; the rest is plain torch
and differentiable, so this is the training encoder. Inputs and outputs are
NHWC like the JAX encoder; weights stay float32 and are cast to the compute
dtype at use. With `lora_rank` r > 0 (ENCODER_LORA) each block's qkv is a
LoRAQKV: rank-r adapters on the q and v slices (the JAX encoder's
vit.py:141-154), under the reference's state-dict keys
(attn.qkv.linear_{a,b}_{q,v}.weight); the fused encoder refuses such a
module. With `remat` (REMAT_ENCODER) each block is checkpointed
(torch.utils.checkpoint), as the JAX encoder's nn.remat(Block): only the
block inputs persist to the backward pass, which recomputes the block. The
fused path over the same module is models/fast_encoder.py.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from sam_road_tpu_torch.ops.attention import fused_attention

ENCODER_SPECS = {
    "vit_b": dict(embed_dim=768, depth=12, num_heads=12, global_attn_indexes=(2, 5, 8, 11)),
    "vit_l": dict(embed_dim=1024, depth=24, num_heads=16, global_attn_indexes=(5, 11, 17, 23)),
    "vit_h": dict(embed_dim=1280, depth=32, num_heads=16, global_attn_indexes=(7, 15, 23, 31)),
    # tiny encoder for tests and smoke runs
    "vit_t": dict(embed_dim=64, depth=2, num_heads=2, global_attn_indexes=(1,)),
}


class LayerNorm2d(nn.Module):
    """Channel LayerNorm over NHWC maps (SAM's LayerNorm2d), fp32 math,
    output in the input dtype."""

    def __init__(self, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) / torch.sqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


def rel_pos_table(size: int, rel_pos):
    """(size, size, head_dim) table: entry (i, j) = rel_pos[i - j + size - 1]."""
    if rel_pos.shape[0] != 2 * size - 1:
        raise ValueError(f"rel_pos table {tuple(rel_pos.shape)} does not match size {size}")
    idx = torch.arange(size)
    coords = idx[:, None] - idx[None, :] + size - 1
    return rel_pos[coords.to(rel_pos.device)]


def linear(x, layer: nn.Linear):
    """nn.Linear in the dtype of x."""
    b = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), b)


def layer_norm(x, norm: nn.LayerNorm):
    """LayerNorm with fp32 math, output in the dtype of x."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps).to(x.dtype)


def fold_rel_pos_qk(q, k, Rh, Rw, hw, scale):
    """Fold the decomposed rel-pos bias into one score product
    (sam_road_tpu/models/vit.py::fold_rel_pos_qk over the full grid):
      q~ = [q * scale, q.Rh (row qh), q.Rw (row qw), 0 ...]
      k~ = [k,         onehot(kh),    onehot(kw),    0 ...]
    so q~.k~ = q.k * scale + rel_h[qh, kh] + rel_w[qw, kw]. q, k [G, nH, N,
    hd] over the (H, W) grid, N = H * W; Rh [H, H, hd], Rw [W, W, hd] in
    q's dtype. The one-hot columns are exact in bf16. Both are padded with
    zero columns to a width D that is a multiple of 16 (hd + H + W = 92 at
    ViT-B's 14 x 14 windows becomes 96), which adds nothing to a score: K5's
    kernel copies 16-byte rows, and a 92-wide bf16 row is 184 bytes."""
    H, W = hw
    G, nh, N, hd = q.shape
    pad = -(hd + H + W) % 16
    r_q = q.reshape(G, nh, H, W, hd)
    qh = torch.einsum("gnhwc,hkc->gnhwk", r_q, Rh).reshape(G, nh, N, H)
    qw = torch.einsum("gnhwc,wkc->gnhwk", r_q, Rw).reshape(G, nh, N, W)
    zeros = q.new_zeros((G, nh, N, pad))
    q_aug = torch.cat([q * scale, qh, qw, zeros], dim=-1)
    idx = torch.arange(N, device=q.device)
    pos = torch.cat([F.one_hot(idx // W, H), F.one_hot(idx % W, W)], dim=1).to(q.dtype)
    k_aug = torch.cat([k, pos.expand(G, nh, N, H + W), zeros], dim=-1)
    return q_aug, k_aug


class LoRAQKV(nn.Linear):
    """The qkv projection with rank-r LoRA adapters on its q and v slices
    (the reference's _LoRA_qkv, model.py:152-187): the first `dim` output
    columns gain b_q(a_q(x)), the last `dim` gain b_v(a_v(x)). B starts at
    zero, so a fresh adapter leaves the projection unchanged. Computes in
    the dtype of x."""

    def __init__(self, dim: int, rank: int):
        super().__init__(dim, 3 * dim)
        self.linear_a_q = nn.Linear(dim, rank, bias=False)
        self.linear_b_q = nn.Linear(rank, dim, bias=False)
        self.linear_a_v = nn.Linear(dim, rank, bias=False)
        self.linear_b_v = nn.Linear(rank, dim, bias=False)
        nn.init.zeros_(self.linear_b_q.weight)
        nn.init.zeros_(self.linear_b_v.weight)

    def forward(self, x):
        dim = self.in_features
        qkv = linear(x, self)
        new_q = linear(linear(x, self.linear_a_q), self.linear_b_q)
        new_v = linear(linear(x, self.linear_a_v), self.linear_b_v)
        return torch.cat([qkv[..., :dim] + new_q, qkv[..., dim:-dim],
                          qkv[..., -dim:] + new_v], dim=-1)


class Attention(nn.Module):
    """Multi-head attention with decomposed relative position bias over a
    (H, W) token grid (a window, or the whole grid in global blocks). With
    use_flash and H * W >= 128 it runs through K5 over the folded q and k;
    otherwise the bias is added to the score matrix. lora_rank > 0 makes
    qkv a LoRAQKV."""

    def __init__(self, dim: int, num_heads: int, input_size: tuple, use_flash: bool = True,
                 lora_rank: int = 0):
        super().__init__()
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.lora_rank = lora_rank
        head_dim = dim // num_heads
        self.qkv = LoRAQKV(dim, lora_rank) if lora_rank > 0 else nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, head_dim))

    def forward(self, x):
        B, H, W, C = x.shape
        nh = self.num_heads
        hd = C // nh
        h = x.reshape(B, H * W, C)
        qkv = self.qkv(h) if self.lora_rank > 0 else linear(h, self.qkv)
        q, k, v = qkv.reshape(B, H * W, 3, nh, hd).permute(2, 0, 3, 1, 4)
        Rh = rel_pos_table(H, self.rel_pos_h).to(x.dtype)
        Rw = rel_pos_table(W, self.rel_pos_w).to(x.dtype)
        if self.use_flash and H * W >= 128:
            q_aug, k_aug = fold_rel_pos_qk(q, k, Rh, Rw, (H, W), hd ** -0.5)
            out = fused_attention(q_aug, k_aug, v.contiguous())
        else:
            attn = torch.matmul(q * hd ** -0.5, k.transpose(-1, -2)).float()
            r_q = q.reshape(B, nh, H, W, hd)
            rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, Rh).float()
            rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, Rw).float()
            attn = (attn.reshape(B, nh, H, W, H, W) + rel_h[..., None]
                    + rel_w[..., None, :]).reshape(B, nh, H * W, H * W)
            attn = torch.softmax(attn, dim=-1).to(x.dtype)
            out = torch.matmul(attn, v)
        return linear(out.permute(0, 2, 1, 3).reshape(B, H, W, C), self.proj)


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, act=F.gelu):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)
        self.act = act

    def forward(self, x):
        return linear(self.act(linear(x, self.lin1)), self.lin2)


def window_partition(x, ws: int):
    """[B, H, W, C] -> [B*nW, ws, ws, C], zero padding H, W up to
    multiples of ws."""
    B, H, W, C = x.shape
    pad_h, pad_w = (ws - H % ws) % ws, (ws - W % ws) % ws
    x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, C), (Hp, Wp)


def window_unpartition(windows, ws: int, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    C = windows.shape[-1]
    B = windows.shape[0] // (Hp * Wp // ws // ws)
    x = windows.reshape(B, Hp // ws, Wp // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, C)[:, :H, :W, :]


class Block(nn.Module):
    """LN -> (windowed) attention -> residual -> LN -> MLP -> residual."""

    def __init__(self, dim, num_heads, mlp_ratio, window_size, input_size, use_flash=True,
                 lora_rank=0):
        super().__init__()
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        attn_size = (window_size, window_size) if window_size > 0 else input_size
        self.attn = Attention(dim, num_heads, attn_size, use_flash, lora_rank)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def forward(self, x):
        h = layer_norm(x, self.norm1)
        if self.window_size > 0:
            H, W = x.shape[1:3]
            h, pad_hw = window_partition(h, self.window_size)
            h = window_unpartition(self.attn(h), self.window_size, pad_hw, (H, W))
        else:
            h = self.attn(h)
        x = x + h
        return x + self.mlp(layer_norm(x, self.norm2))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, x):  # NHWC -> NHWC
        w = self.proj.weight.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, self.proj.bias.to(x.dtype),
                     stride=self.proj.stride)
        return y.permute(0, 2, 3, 1)


class ImageEncoderViT(nn.Module):
    """SAM image encoder: [B, img, img, 3] normalised NHWC ->
    [B, img/16, img/16, out_chans]."""

    def __init__(self, img_size=1024, patch_size=16, embed_dim=768, depth=12,
                 num_heads=12, mlp_ratio=4.0, out_chans=256, window_size=14,
                 global_attn_indexes=(2, 5, 8, 11), use_flash=True, dtype=torch.float32,
                 remat=False, lora_rank=0):
        super().__init__()
        self.img_size = img_size
        self.remat = remat
        self.lora_rank = lora_rank
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.window_size = window_size
        self.global_attn_indexes = tuple(global_attn_indexes)
        self.dtype = dtype
        grid = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
        self.blocks = nn.ModuleList([
            Block(embed_dim, num_heads, mlp_ratio,
                  0 if i in self.global_attn_indexes else window_size, (grid, grid), use_flash,
                  lora_rank)
            for i in range(depth)
        ])
        self.neck = nn.Sequential(
            nn.Conv2d(embed_dim, out_chans, 1, bias=False),
            LayerNorm2d(out_chans),
            nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
            LayerNorm2d(out_chans),
        )

    def embed(self, x):
        """Patch embedding + absolute position embedding, in self.dtype."""
        x = self.patch_embed(x.to(self.dtype))
        return x + self.pos_embed.to(self.dtype)

    def apply_neck(self, x):
        """1x1 conv -> LN2d -> 3x3 conv -> LN2d on NHWC maps."""
        conv0, ln1, conv2, ln3 = self.neck
        x = F.conv2d(x.permute(0, 3, 1, 2), conv0.weight.to(x.dtype))
        x = ln1(x.permute(0, 2, 3, 1))
        x = F.conv2d(x.permute(0, 3, 1, 2), conv2.weight.to(x.dtype), padding=1)
        return ln3(x.permute(0, 2, 3, 1))

    def forward(self, x):
        x = self.embed(x)
        remat = self.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            x = checkpoint(blk, x, use_reentrant=False) if remat else blk(x)
        return self.apply_neck(x)
