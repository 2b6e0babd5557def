"""Drawing and the graph overlays (counterparts of render_val_mask_panel,
save_val_visualizations, visualize_image_and_graph, rasterize_graph and
visualize_pred_gt_pair in sam_road_tpu/utils/viz.py), written with
data/png.py: the GPU machine has no cv2.

draw_lines, draw_disks and draw_rects set the pixels that cv2.line (LINE_8),
cv2.circle(..., -1) and cv2.rectangle(..., -1) set, exactly: lines and disks
are drawn in C++ (csrc/draw.cc, built with g++ at first use; a failed build
raises), rectangles by slicing. The label masks (data/label_gen.py) are
drawn with them, so the port trains on the JAX package's labels byte for
byte. resize_bilinear is cv2.resize's INTER_LINEAR up to its fixed-point
rounding (within one level).
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from sam_road_tpu_torch._native import PKG_DIR, build_and_load
from sam_road_tpu_torch.data.png import read_png, write_png


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


@functools.cache
def _lib():
    dll = build_and_load("samroad_draw", "g++", ["-O3", "-shared", "-fPIC", "-std=c++17"],
                         [os.path.join(PKG_DIR, "csrc", "draw.cc")])
    args = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    for fn in (dll.samroad_draw_lines, dll.samroad_draw_disks):
        fn.restype = None
        fn.argtypes = args
    return dll


def _target(img, color):
    """(channels, colour bytes) of a C-contiguous uint8 [H, W] or [H, W, C]
    image, drawn on in place. A colour is a number or a tuple, padded with
    zeros or cut to the channel count and saturated to 0-255, as cv2 reads a
    Scalar."""
    if not (isinstance(img, np.ndarray) and img.dtype == np.uint8 and img.ndim in (2, 3)
            and img.flags.c_contiguous):
        raise TypeError("draws on a C-contiguous uint8 [H, W] or [H, W, C] array")
    ch = 1 if img.ndim == 2 else img.shape[2]
    c = np.zeros(ch, np.float64)
    values = np.atleast_1d(np.asarray(color, np.float64))[:ch]
    c[:values.shape[0]] = values
    return ch, np.clip(np.rint(c), 0, 255).astype(np.uint8)


def _points(p):
    return np.ascontiguousarray(np.asarray(p, np.int64).reshape(-1, 2))


def draw_lines(img, p0, p1, color, thickness: int = 4):
    """The lines from integer (x, y) points p0[i] to p1[i] ([N, 2] each),
    as cv2.line(img, p0[i], p1[i], color, thickness) draws each; in place,
    returns img."""
    if not 0 < thickness <= 32767:
        raise ValueError(f"thickness must be in [1, 32767], got {thickness}")
    ch, col = _target(img, color)
    p0, p1 = _points(p0), _points(p1)
    if p0.shape != p1.shape:
        raise ValueError(f"p0 {p0.shape} and p1 {p1.shape} differ")
    segs = np.ascontiguousarray(np.concatenate([p0, p1], axis=1))
    _lib().samroad_draw_lines(img.ctypes.data, img.shape[0], img.shape[1], ch,
                              segs.ctypes.data, segs.shape[0], col.ctypes.data, int(thickness))
    return img


def draw_disks(img, centers, radius: int, color):
    """Filled circles of `radius` at integer (x, y) centers ([N, 2]), as
    cv2.circle(img, center, radius, color, -1) draws each; in place,
    returns img."""
    if radius < 0:
        raise ValueError(f"radius must be >= 0, got {radius}")
    ch, col = _target(img, color)
    centers = _points(centers)
    _lib().samroad_draw_disks(img.ctypes.data, img.shape[0], img.shape[1], ch,
                              centers.ctypes.data, centers.shape[0], col.ctypes.data,
                              int(radius))
    return img


def draw_rects(img, p0, p1, color):
    """Filled rectangles with integer (x, y) corners p0[i] and p1[i]
    (inclusive, any order), clipped to the image, as
    cv2.rectangle(img, p0[i], p1[i], color, -1) draws each; in place,
    returns img."""
    ch, col = _target(img, color)
    h, w = img.shape[:2]
    value = col if ch > 1 else col[0]
    for (xa, ya), (xb, yb) in zip(_points(p0), _points(p1)):
        x0, x1 = max(min(xa, xb), 0), min(max(xa, xb), w - 1)
        y0, y1 = max(min(ya, yb), 0), min(max(ya, yb), h - 1)
        if x0 <= x1 and y0 <= y1:
            img[y0:y1 + 1, x0:x1 + 1] = value
    return img


def _pixels(nodes, size: int):
    """Normalised (r, c) nodes -> integer (x, y) pixels at `size`: scaled in
    the nodes' own float type and truncated, as the JAX functions' int() of
    each coordinate."""
    rc = np.asarray(nodes)
    if not np.issubdtype(rc.dtype, np.floating):
        rc = rc.astype(np.float64)
    return np.trunc(rc.reshape(-1, 2)[:, ::-1] * size).astype(np.int64)


def visualize_image_and_graph(img, nodes, edges, viz_img_size=512):
    """Overlay a road graph on an image (sam_road_tpu/utils/viz.py's, after
    the reference's triage.py): resize to viz_img_size, swap the channel
    order, edges as lines of width 4 in (15, 160, 253), then nodes as filled
    disks of radius 4 in (0, 255, 255). nodes are normalised (r, c) in
    [0, 1]; returns the BGR image (write its [..., ::-1] with write_png to
    get the file cv2.imwrite would)."""
    img = np.ascontiguousarray(resize_bilinear(np.asarray(img), viz_img_size)[..., ::-1])
    pts = _pixels(nodes, viz_img_size)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    draw_lines(img, pts[edges[:, 0]], pts[edges[:, 1]], EDGE_BGR, 4)
    draw_disks(img, pts, 4, NODE_BGR)
    return img


def rasterize_graph(nodes, edges, viz_img_size, dilation_radius):
    """A graph drawn white on black, [S, S, 3] uint8: each node a filled
    square of half-side dilation_radius, each edge a line of width
    2 * dilation_radius. nodes are normalised (r, c) in [0, 1]."""
    img = np.zeros((viz_img_size, viz_img_size, 3), dtype=np.uint8)
    pts = _pixels(nodes, viz_img_size)
    draw_rects(img, pts - dilation_radius, pts + dilation_radius, (255, 255, 255))
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    draw_lines(img, pts[edges[:, 0]], pts[edges[:, 1]], (255, 255, 255), dilation_radius * 2)
    return img


def _read_bgr(path: str):
    """A PNG tile as uint8 [H, W, 3] in BGR order, as cv2.imread gives it
    (a grayscale image repeated into three channels)."""
    img = read_png(path)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    return np.ascontiguousarray(img[..., ::-1])


def visualize_pred_gt_pair(result):
    """Side by side, the predicted and the ground-truth graph of one triage
    record (img_path, pred_nodes, pred_edges, gt_nodes, gt_edges) over its
    tile: [512, 1024, 3], BGR."""
    img = _read_bgr(result["img_path"])
    pred_img = visualize_image_and_graph(img, result["pred_nodes"], result["pred_edges"])
    gt_img = visualize_image_and_graph(img, result["gt_nodes"], result["gt_edges"])
    return np.concatenate((pred_img, gt_img), axis=1)


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
