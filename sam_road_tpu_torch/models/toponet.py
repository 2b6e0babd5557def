"""TopoNet, the edge classifier over sampled point features (counterpart
of sam_road_tpu/models/toponet.py).

Projects point features 256 -> 128, builds pair features [src, tgt,
tgt - src], runs a 3-layer post-norm transformer encoder (eps 1e-5, ReLU
FFN, nn.TransformerEncoderLayer semantics) within each sample group under a
key-padding mask, and emits one logit per pair. Masked keys get
finfo(float32).min and the softmax is fp32. Groups whose pairs are all
invalid have their mask flipped to avoid NaN. 'no_transformer' has no
encoder layers (no parameters, as in the JAX module). The reference's dead
'no_tgt_features' branch is kept: that version behaves as 'normal'.
Training (deterministic=False) applies dropout at p = 0.1 after
self-attention and twice in the feed-forward, as the JAX layer does, with
masks drawn from an explicit torch.Generator.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sam_road_tpu_torch.models.vit import layer_norm, linear


class MultiheadSelfAttention(nn.Module):
    """nn.MultiheadAttention-compatible parameters (in_proj_weight,
    in_proj_bias, out_proj) for self-attention with a key padding mask."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x, key_padding_mask=None):
        B, N, C = x.shape
        nh = self.num_heads
        hd = C // nh
        dt = x.dtype
        qkv = F.linear(x, self.in_proj_weight.to(dt), self.in_proj_bias.to(dt))
        q, k, v = (t.reshape(B, N, nh, hd).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        attn = torch.matmul(q / torch.tensor(hd ** 0.5, dtype=dt), k.transpose(-1, -2)).float()
        if key_padding_mask is not None:
            attn = attn.masked_fill(key_padding_mask[:, None, None, :],
                                    torch.finfo(torch.float32).min)
        attn = torch.softmax(attn, dim=-1).to(dt)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, N, C)
        return linear(out, self.out_proj)


DROPOUT = 0.1  # the reference layer's dropout rate


def dropout(x, p: float, deterministic: bool, generator=None):
    """Inverted dropout with the keep mask drawn from `generator` (flax
    nn.Dropout semantics: kept entries scaled by 1 / (1 - p)); the identity
    when deterministic."""
    if deterministic:
        return x
    keep = torch.empty(x.shape, device=x.device).bernoulli_(1.0 - p, generator=generator)
    return x * (keep / (1.0 - p)).to(x.dtype)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, ffn_dim: int):
        super().__init__()
        self.self_attn = MultiheadSelfAttention(dim, num_heads)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, key_padding_mask=None, deterministic=True, generator=None):
        def drop(t):
            return dropout(t, DROPOUT, deterministic, generator)

        x = layer_norm(x + drop(self.self_attn(x, key_padding_mask)), self.norm1)
        h = drop(F.relu(linear(x, self.linear1)))
        h = drop(linear(h, self.linear2))
        return layer_norm(x + h, self.norm2)


class _Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class TopoNet(nn.Module):
    def __init__(self, feature_dim: int = 256, hidden_dim: int = 128,
                 num_heads: int = 4, num_attn_layers: int = 3,
                 version: str = "normal"):
        super().__init__()
        self.version = version
        self.hidden_dim = hidden_dim
        self.feature_proj = nn.Linear(feature_dim, hidden_dim)
        self.pair_proj = nn.Linear(2 * hidden_dim + 2, hidden_dim)
        if version != "no_transformer":  # as the JAX module, which never builds them
            self.transformer_encoder = _Encoder([
                TransformerEncoderLayer(hidden_dim, num_heads, hidden_dim)
                for _ in range(num_attn_layers)
            ])
        self.output_proj = nn.Linear(hidden_dim, 1)

    def forward(self, points, point_features, pairs, pairs_valid, deterministic=True,
                generator=None):
        """points [B, P, 2], point_features [B, P, D], pairs [B, S, K, 2]
        indices into the points, pairs_valid [B, S, K] bool. Returns
        (logits, fp32 scores), both [B, S, K, 1]. Runs in the dtype of
        point_features; dropout only with deterministic=False."""
        dt = point_features.dtype
        pf = F.relu(linear(point_features, self.feature_proj))
        B, S, K, _ = pairs.shape
        flat = pairs.reshape(B, S * K, 2).long()

        def take(t, idx):
            return torch.gather(t, 1, idx[..., None].expand(B, idx.shape[1], t.shape[-1]))

        src_f, tgt_f = take(pf, flat[..., 0]), take(pf, flat[..., 1])
        pts = points.to(dt)
        offset = take(pts, flat[..., 1]) - take(pts, flat[..., 0])
        if self.version == "no_offset":
            offset = torch.zeros_like(offset)
        pair_f = F.relu(linear(torch.cat([src_f, tgt_f, offset], dim=2), self.pair_proj))
        pair_f = pair_f.reshape(B * S, K, self.hidden_dim)
        valid = pairs_valid.reshape(B * S, K).bool()
        all_invalid = (valid.sum(dim=-1) == 0)[:, None]
        padding_mask = ~(valid | all_invalid)
        if self.version != "no_transformer":
            for layer in self.transformer_encoder.layers:
                pair_f = layer(pair_f, padding_mask, deterministic, generator)
        logits = linear(pair_f.reshape(B, S, K, self.hidden_dim), self.output_proj)
        return logits, torch.sigmoid(logits.float())
