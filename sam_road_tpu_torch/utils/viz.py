"""Validation panels and the graph overlay (counterparts of
render_val_mask_panel, save_val_visualizations and visualize_image_and_graph
in sam_road_tpu/utils/viz.py), drawn in numpy and written with data/png.py:
the GPU machine has no cv2. rasterize_graph is not ported yet."""

from __future__ import annotations

import os

import numpy as np

from sam_road_tpu_torch.data.png import write_png


def render_val_mask_panel(rgb, gt_keypoint, gt_road, pred_keypoint, pred_road):
    """One validation sample as [rgb | GT masks | predicted masks], the
    masks as keypoint in red over road in green. rgb [H, W, 3] float
    0-255, masks [H, W] float 0-1; returns uint8 RGB [H, 3W + 16, 3]."""
    h, w = gt_road.shape

    def mask_img(kp, road):
        img = np.zeros((h, w, 3), np.float32)
        img[..., 1] = np.clip(road, 0, 1) * 255.0
        img[..., 0] = np.clip(kp, 0, 1) * 255.0
        return img

    sep = np.full((h, 8, 3), 255.0, np.float32)
    panel = np.concatenate([np.clip(rgb, 0, 255), sep, mask_img(gt_keypoint, gt_road), sep,
                            mask_img(pred_keypoint, pred_road)], axis=1)
    return panel.astype(np.uint8)


EDGE_BGR = (15, 160, 253)
NODE_BGR = (0, 255, 255)


def resize_bilinear(img, size: int):
    """uint8 [H, W, 3] -> [size, size, 3], bilinear with half-pixel centres
    and clamped edges (cv2.resize's INTER_LINEAR up to its fixed-point
    rounding); the identity at the same size."""
    h, w = img.shape[:2]
    if (h, w) == (size, size):
        return img.copy()

    def axis(n):
        pos = np.clip((np.arange(size) + 0.5) * (n / size) - 0.5, 0, n - 1)
        i0 = np.floor(pos).astype(np.int64)
        i1 = np.minimum(i0 + 1, n - 1)
        return i0, i1, (pos - i0)

    y0, y1, fy = axis(h)
    x0, x1, fx = axis(w)
    f = img.astype(np.float64)
    top = f[y0][:, x0] * (1 - fx)[None, :, None] + f[y0][:, x1] * fx[None, :, None]
    bot = f[y1][:, x0] * (1 - fx)[None, :, None] + f[y1][:, x1] * fx[None, :, None]
    out = top * (1 - fy)[:, None, None] + bot * fy[:, None, None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _set(img, ys, xs, color):
    keep = (ys >= 0) & (ys < img.shape[0]) & (xs >= 0) & (xs < img.shape[1])
    img[ys[keep], xs[keep]] = color


def _ranges(starts, counts):
    """(owner, value) for the integer ranges [starts[i], starts[i] +
    counts[i]) laid end to end: owner i repeated counts[i] times."""
    counts = np.maximum(counts, 0).astype(np.int64)
    owner = np.repeat(np.arange(counts.shape[0]), counts)
    first = np.cumsum(counts) - counts
    return owner, starts[owner] + (np.arange(owner.shape[0]) - first[owner])


def draw_lines(img, p0, p1, color, thickness: int = 4):
    """Thick lines between integer (x, y) points p0[i] and p1[i], drawn as
    cv2.line draws each for an even thickness: the rectangle offset
    thickness / 2 to each side (corners rounded to 1/65536), scan-filled row by row from
    round(left) to round(right) and outlined with 8-connected segments, with
    a disk of radius thickness // 2 at each end."""
    p0 = np.asarray(p0, np.float64).reshape(-1, 2)
    p1 = np.asarray(p1, np.float64).reshape(-1, 2)
    half = thickness / 2
    dx, dy = p0[:, 0] - p1[:, 0], p1[:, 1] - p0[:, 1]
    long = dx * dx + dy * dy > 0
    if long.any():
        scale = half / np.sqrt(dx[long] ** 2 + dy[long] ** 2)
        off = np.stack([np.round(dy[long] * scale * 65536), np.round(dx[long] * scale * 65536)],
                       1) / 65536
        q0, q1 = p0[long], p1[long]
        poly = np.stack([q0 + off, q0 - off, q1 - off, q1 + off], 1)  # [E, 4, (x, y)]
        a, b = np.roll(poly, 1, axis=1), poly  # edge k of a polygon runs a[:, k] -> b[:, k]
        y_lo = np.ceil(poly[..., 1].min(1)).astype(np.int64)
        y_hi = np.floor(poly[..., 1].max(1)).astype(np.int64)
        owner, rows = _ranges(y_lo, y_hi - y_lo + 1)
        ay, by, ax, bx = a[owner, :, 1], b[owner, :, 1], a[owner, :, 0], b[owner, :, 0]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (rows[:, None] - ay) / (by - ay)
        cut = (by != ay) & (t >= 0) & (t <= 1)
        xs = ax + np.where(cut, t, 0.0) * (bx - ax)
        lo = np.floor(np.where(cut, xs, np.inf).min(1) + 0.5)
        hi = np.floor(np.where(cut, xs, -np.inf).max(1) + 0.5)
        span = cut.any(1)
        row_of, cols = _ranges(np.where(span, lo, 0).astype(np.int64),
                               np.where(span, hi - lo + 1, 0).astype(np.int64))
        _set(img, rows[row_of], cols, color)
        # the outline: 8-connected segments along the 4 sides
        sa, sb = a.reshape(-1, 2), b.reshape(-1, 2)
        n = np.maximum(np.abs(np.rint(sb[:, 0]) - np.rint(sa[:, 0])),
                       np.abs(np.rint(sb[:, 1]) - np.rint(sa[:, 1]))).astype(np.int64)
        seg, step = _ranges(np.zeros_like(n), n + 1)
        t = step / np.maximum(n[seg], 1)
        _set(img, np.floor(sa[seg, 1] + t * (sb[seg, 1] - sa[seg, 1]) + 0.5).astype(np.int64),
             np.floor(sa[seg, 0] + t * (sb[seg, 0] - sa[seg, 0]) + 0.5).astype(np.int64), color)
    draw_disks(img, np.concatenate([p0, p1]).astype(np.int64), thickness // 2, color)


def draw_disks(img, centers, radius: int, color):
    """Filled circles at integer (x, y) centers, as cv2.circle(..., -1)
    draws each: the pixels with x^2 + y^2 <= r^2."""
    dy, dx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    inside = dx * dx + dy * dy <= radius * radius
    centers = np.asarray(centers, np.int64).reshape(-1, 2)
    _set(img, (centers[:, 1:2] + dy[inside][None]).ravel(),
         (centers[:, 0:1] + dx[inside][None]).ravel(), color)


def visualize_image_and_graph(img, nodes, edges, viz_img_size=512):
    """Overlay a road graph on an image (sam_road_tpu/utils/viz.py's, after
    the reference's triage.py): resize to viz_img_size, RGB -> BGR, edges as
    lines of width 4 in (15, 160, 253), then nodes as filled disks of radius
    4 in (0, 255, 255). nodes are normalised (r, c) in [0, 1]; returns the
    BGR image (write its [..., ::-1] with write_png to get the file
    cv2.imwrite would)."""
    nodes = np.asarray(nodes, dtype=np.float64).reshape(-1, 2)[:, ::-1]  # (r, c) -> (x, y)
    img = np.ascontiguousarray(resize_bilinear(np.asarray(img), viz_img_size)[..., ::-1])
    pts = np.trunc(nodes * viz_img_size).astype(np.int64)  # cv2's int() of each coordinate
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    draw_lines(img, pts[edges[:, 0]], pts[edges[:, 1]], EDGE_BGR, 4)
    draw_disks(img, pts, 4, NODE_BGR)
    return img


def _mask01(x):
    x = np.asarray(x)
    return x.astype(np.float32) / 255.0 if x.dtype == np.uint8 else x.astype(np.float32)


def save_val_visualizations(out_dir, epoch, batch, mask_scores, count=4):
    """Write up to `count` panels of a validation batch (collate_batch's
    format) and its mask scores [B, H, W, 2] as
    <out_dir>/val_epoch{epoch}_sample{i}.png; returns their paths."""
    os.makedirs(out_dir, exist_ok=True)
    scores = np.asarray(mask_scores, np.float32)
    paths = []
    for i in range(min(int(count), scores.shape[0])):
        panel = render_val_mask_panel(
            np.asarray(batch["rgb"][i], np.float32), _mask01(batch["keypoint_mask"][i]),
            _mask01(batch["road_mask"][i]), scores[i, ..., 0], scores[i, ..., 1])
        path = os.path.join(out_dir, f"val_epoch{epoch}_sample{i}.png")
        write_png(path, panel)
        paths.append(path)
    return paths
