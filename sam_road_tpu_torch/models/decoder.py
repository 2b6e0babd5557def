"""The naive map decoder (counterpart of sam_road_tpu/models/decoder.py):
four kernel-2 stride-2 transposed convolutions, 256 -> 128 -> 64 -> 32 -> 2
channels, LayerNorm2d after the first and exact GELU between, on NHWC maps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sam_road_tpu_torch.models.vit import LayerNorm2d


class ConvTranspose2x2(nn.Module):
    """ConvTranspose2d(kernel 2, stride 2) as a dense projection to 4x the
    channels plus a pixel shuffle: out[2i+di, 2j+dj] = x[i, j] . W[:, :, di, dj]
    + b. The weight keeps torch's (in, out, 2, 2) layout."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, 2, 2))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        nn.init.normal_(self.weight, std=in_ch ** -0.5)

    def forward(self, x):
        B, H, W, C = x.shape
        Fo = self.weight.shape[1]
        # (in, out, di, dj) -> (in, di, dj, out) -> (in, 4*out)
        w = self.weight.to(x.dtype).permute(0, 2, 3, 1).reshape(C, 4 * Fo)
        y = (x.reshape(B * H * W, C) @ w).reshape(B, H, W, 2, 2, Fo)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(B, 2 * H, 2 * W, Fo)
        return y + self.bias.to(x.dtype)


class MapDecoder(nn.Sequential):
    """[B, h, w, 256] -> [B, 16h, 16w, 2] logits (keypoint, road). The slots
    match the reference nn.Sequential, so its keys (0, 1, 3, 5, 7) load by
    name."""

    def __init__(self, in_ch: int = 256, out_channels: int = 2):
        super().__init__(
            ConvTranspose2x2(in_ch, 128), LayerNorm2d(128), nn.GELU(),
            ConvTranspose2x2(128, 64), nn.GELU(),
            ConvTranspose2x2(64, 32), nn.GELU(),
            ConvTranspose2x2(32, out_channels),
        )

    def forward(self, x):
        for layer in self:
            x = F.gelu(x) if isinstance(layer, nn.GELU) else layer(x)
        return x
