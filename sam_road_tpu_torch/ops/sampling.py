"""Bilinear point sampling from NHWC feature maps (counterpart of
sam_road_tpu/ops/sampling.py)."""

from __future__ import annotations

import torch


def bilinear_sample_points(feature_maps, sample_points, patch_size):
    """Sample features at continuous (x, y) pixel locations.

    F.grid_sample semantics (bilinear, align_corners=False, zero padding),
    written as a gather + lerp like the JAX code, with the lerp in the
    feature dtype.

    feature_maps [B, H, W, D]; sample_points [B, N, 2] (x, y) in patch
    pixels, range [0, patch_size]. Returns [B, N, D].
    """
    B, H, W, D = feature_maps.shape
    dt = feature_maps.dtype
    pts = sample_points.float()
    px = pts[..., 0] / patch_size * W - 0.5
    py = pts[..., 1] / patch_size * H - 0.5
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx = (px - x0)[..., None].to(dt)
    wy = (py - y0)[..., None].to(dt)
    x0i = x0.long()
    y0i = y0.long()
    flat = feature_maps.reshape(B, H * W, D)

    def gather(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        vals = torch.gather(flat, 1, idx[..., None].expand(B, idx.shape[1], D))
        return vals * valid[..., None].to(dt)

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x0i + 1)
    v10 = gather(y0i + 1, x0i)
    v11 = gather(y0i + 1, x0i + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy
