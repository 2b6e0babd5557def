"""SAM mask-decoder head, the USE_SAM_DECODER path (counterpart of
sam_road_tpu/models/sam_decoder.py).

A null-prompt PromptEncoder (the dense no-mask embedding and the random
Fourier positional encoding), SAM's TwoWayTransformer (depth 2, width 256,
8 heads, MLP 2048, cross attention downsampled 2x), and the MaskDecoder with
two multimask outputs (keypoint, road): hypernetwork mask heads over a 4x
upscaling of the image tokens, then a bilinear resize to the patch. The
modules carry SAM's torch names, so a SAM checkpoint's prompt_encoder.* and
mask_decoder.* keys load by name (the JAX package's convert_sam_decoder_key
maps those same keys to its tree).

The math follows the JAX head, step for step and dtype for dtype: linear
layers and norms in the compute dtype (norm statistics in fp32), attention
scores and softmax in fp32 cast back to the compute dtype, the mask product
in fp32. Its products are plain torch.matmul: the JAX head computes them in
XLA, outside any Pallas kernel. Two of its choices are kept as JAX makes
them: the dense positional-encoding grid stacks (y, x), and the Gaussian
matrix is a trained parameter. The iou head runs in every forward and its
output is dropped, as in JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sam_road_tpu_torch.models.decoder import ConvTranspose2x2
from sam_road_tpu_torch.models.vit import LayerNorm2d, MLPBlock, layer_norm, linear


class SamAttention(nn.Module):
    """SAM's attention: q / k / v projections to embedding_dim /
    downsample_rate, separate heads, the output projection back."""

    def __init__(self, embedding_dim: int, num_heads: int, downsample_rate: int = 1):
        super().__init__()
        internal = embedding_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embedding_dim, internal)
        self.k_proj = nn.Linear(embedding_dim, internal)
        self.v_proj = nn.Linear(embedding_dim, internal)
        self.out_proj = nn.Linear(internal, embedding_dim)

    def forward(self, q, k, v):
        def heads(t):
            B, N, C = t.shape
            return t.reshape(B, N, self.num_heads, C // self.num_heads).transpose(1, 2)

        qh, kh, vh = (heads(linear(t, layer)) for t, layer in
                      ((q, self.q_proj), (k, self.k_proj), (v, self.v_proj)))
        scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
        attn = torch.softmax(scores / math.sqrt(qh.shape[-1]), dim=-1).to(q.dtype)
        out = torch.matmul(attn, vh)
        B, _, N, _ = out.shape
        return linear(out.transpose(1, 2).reshape(B, N, -1), self.out_proj)


class TwoWayAttentionBlock(nn.Module):
    """Token self-attention, token-to-image and image-to-token cross
    attention, and the token MLP (ReLU), each followed by a LayerNorm."""

    def __init__(self, embedding_dim: int = 256, num_heads: int = 8, mlp_dim: int = 2048,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = SamAttention(embedding_dim, num_heads)
        self.norm1 = nn.LayerNorm(embedding_dim)
        self.cross_attn_token_to_image = SamAttention(embedding_dim, num_heads, 2)
        self.norm2 = nn.LayerNorm(embedding_dim)
        self.mlp = MLPBlock(embedding_dim, mlp_dim, act=F.relu)
        self.norm3 = nn.LayerNorm(embedding_dim)
        self.norm4 = nn.LayerNorm(embedding_dim)
        self.cross_attn_image_to_token = SamAttention(embedding_dim, num_heads, 2)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = layer_norm(queries, self.norm1)
        k = keys + key_pe
        queries = queries + self.cross_attn_token_to_image(queries + query_pe, k, keys)
        queries = layer_norm(queries, self.norm2)
        queries = layer_norm(queries + self.mlp(queries), self.norm3)
        keys = keys + self.cross_attn_image_to_token(k, queries + query_pe, queries)
        return queries, layer_norm(keys, self.norm4)


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int = 2, embedding_dim: int = 256, num_heads: int = 8,
                 mlp_dim: int = 2048):
        super().__init__()
        self.layers = nn.ModuleList([
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim, skip_first_layer_pe=i == 0)
            for i in range(depth)])
        self.final_attn_token_to_image = SamAttention(embedding_dim, num_heads, 2)
        self.norm_final_attn = nn.LayerNorm(embedding_dim)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding, image_pe [B, h, w, C]; point_embedding [B, N, C]
        -> (queries [B, N, C], keys [B, h * w, C])."""
        B, h, w, C = image_embedding.shape
        keys = image_embedding.reshape(B, h * w, C)
        key_pe = image_pe.reshape(B, h * w, C)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        attn = self.final_attn_token_to_image(queries + point_embedding, keys + key_pe, keys)
        return layer_norm(queries + attn, self.norm_final_attn), keys


class SamMLP(nn.Module):
    """SAM's MLP: a stack of linear layers (layers.{i}), ReLU between."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList([nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])])

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = linear(x, layer)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int = 128):
        super().__init__()
        self.positional_encoding_gaussian_matrix = nn.Parameter(torch.randn(2, num_pos_feats))

    def dense_pe(self, h: int, w: int):
        """fp32 [h, w, 2 * num_pos_feats] encoding of the cell centres, the
        grid stacked (y, x) as in the JAX head."""
        ys = (np.arange(h, dtype=np.float32) + 0.5) / h
        xs = (np.arange(w, dtype=np.float32) + 0.5) / w
        grid = np.stack(np.meshgrid(ys, xs, indexing="ij"), axis=-1)
        gauss = self.positional_encoding_gaussian_matrix
        coords = 2 * torch.from_numpy(grid).to(gauss.device) - 1
        proj = coords @ gauss.float() * (2 * np.pi)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class PromptEncoder(nn.Module):
    """The null prompt: the dense no-mask embedding and the positional
    encoding of the image grid."""

    def __init__(self, embed_dim: int = 256):
        super().__init__()
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        self.no_mask_embed = nn.Embedding(1, embed_dim)


class MaskDecoder(nn.Module):
    def __init__(self, embed_dim: int = 256, num_multimask_outputs: int = 2):
        super().__init__()
        self.num_mask_tokens = num_multimask_outputs + 1
        self.iou_token = nn.Embedding(1, embed_dim)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, embed_dim)
        self.transformer = TwoWayTransformer(embedding_dim=embed_dim)
        self.output_upscaling = nn.Sequential(
            ConvTranspose2x2(embed_dim, embed_dim // 4), LayerNorm2d(embed_dim // 4), nn.GELU(),
            ConvTranspose2x2(embed_dim // 4, embed_dim // 8), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList([
            SamMLP(embed_dim, embed_dim, embed_dim // 8, 3) for _ in range(self.num_mask_tokens)])
        self.iou_prediction_head = SamMLP(embed_dim, 256, self.num_mask_tokens, 3)

    def upscale(self, x):
        for layer in self.output_upscaling:
            x = F.gelu(x) if isinstance(layer, nn.GELU) else layer(x)
        return x


def resize_masks(masks, size: int):
    """[B, C, h, w] fp32 -> [B, C, size, size] bilinear with half-pixel
    centres and no antialiasing: jax.image.resize's "bilinear" for an
    upscale, the edge rows and columns included (both clamp the sample
    to the first and last centre there)."""
    return F.interpolate(masks, size=(size, size), mode="bilinear", align_corners=False,
                         antialias=False)


def sam_mask_logits(prompt_encoder: PromptEncoder, mask_decoder: MaskDecoder, image_embeddings,
                    image_size: int):
    """NHWC image embeddings [B, h, w, 256] in the compute dtype -> fp32
    mask logits [B, image_size, image_size, 2] (keypoint, road): the
    multimask outputs 1: of SAM's decoder under the null prompt, resized
    to the patch by resize_masks."""
    B, h, w, C = image_embeddings.shape
    dtype = image_embeddings.dtype
    image_pe = prompt_encoder.pe_layer.dense_pe(h, w).to(dtype).expand(B, h, w, C)
    src = image_embeddings + prompt_encoder.no_mask_embed.weight.to(dtype).reshape(1, 1, 1, C)
    tokens = torch.cat([mask_decoder.iou_token.weight, mask_decoder.mask_tokens.weight], dim=0)
    tokens = tokens.to(dtype).expand(B, -1, -1)
    hs, keys = mask_decoder.transformer(src, image_pe, tokens)
    n = mask_decoder.num_mask_tokens
    upscaled = mask_decoder.upscale(keys.reshape(B, h, w, C))
    hyper_in = torch.stack([mlp(hs[:, 1 + i]) for i, mlp in
                            enumerate(mask_decoder.output_hypernetworks_mlps)], dim=1)
    masks = torch.einsum("bnc,bhwc->bnhw", hyper_in.float(), upscaled.float())
    mask_decoder.iou_prediction_head(hs[:, 0])  # dropped, as in the JAX head
    return resize_masks(masks[:, 1:n], image_size).permute(0, 2, 3, 1)


class SamMaskDecoderHead(nn.Module):
    """The JAX SamMaskDecoderHead as a module: prompt_encoder and
    mask_decoder, composed by sam_mask_logits. SAMRoad holds the two
    directly, so their keys sit at the top of its state dict as in SAM's
    checkpoints."""

    def __init__(self, image_size: int, embed_dim: int = 256):
        super().__init__()
        self.image_size = image_size
        self.prompt_encoder = PromptEncoder(embed_dim)
        self.mask_decoder = MaskDecoder(embed_dim)

    def forward(self, image_embeddings):
        return sam_mask_logits(self.prompt_encoder, self.mask_decoder, image_embeddings,
                               self.image_size)
