"""Region inference in plain PyTorch and NumPy, written from SAM-Road's
published inference (github.com/htcr/sam_road, inferencer.py and
graph_extraction.py): an overlapping grid of patches over the region, each
patch's mask scores averaged where patches overlap, vertices by
thresholding and greedy radius NMS, each vertex paired with its nearest
neighbours inside every patch that holds it, TopoNet's scores averaged over
the patches that scored a pair, and the pairs above TOPO_THRESHOLD kept.

Two rules follow the program's documented numerics, because its outputs
are compared to these bit for bit:
  - mask fusion in 1/1024 fixed point, truncated to uint8;
  - the NMS visiting order of np.argsort(scores)[::-1].
Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial import cKDTree

from benchmark.reference import model

MASK_QUANT = 1024


def patch_grid(size: int, margin: int, patch: int, per_edge: int) -> list:
    """(x0, y0) origins of the patch grid, x-major: per_edge evenly spaced
    origins from margin to size - patch - margin on each axis."""
    xs = [round(x) for x in np.linspace(margin, size - (patch + margin), per_edge)]
    return [(x, y) for x in xs for y in xs]


def crops(img_dev, origins, patch: int):
    """The patches at `origins` from a [H, W, 3] uint8 tensor, as float."""
    return torch.stack([img_dev[y:y + patch, x:x + patch] for x, y in origins]).float()


@torch.no_grad()
def masks_and_features(sd, arch, img: np.ndarray, cfg: dict, device, prec=model.FP32,
                       block: int = 16):
    """The region's fused uint8 masks [H, W, 2] (keypoint, road) and every
    patch's embeddings [n, 256, h, w], computed `block` patches at a time."""
    size, p = img.shape[0], cfg["PATCH_SIZE"]
    origins = patch_grid(size, cfg["SAMPLE_MARGIN"], p, cfg["INFER_PATCHES_PER_EDGE"])
    img_dev = torch.from_numpy(img).to(device)
    fused = torch.zeros((size, size, 2), dtype=torch.int64, device=device)
    count = torch.zeros((size, size), dtype=torch.int64, device=device)
    feats = []
    for b0 in range(0, len(origins), block):
        xy = origins[b0:b0 + block]
        emb = model.encoder(sd, crops(img_dev, xy, p), arch, prec)
        scores = torch.sigmoid(model.decoder(sd, emb, prec))
        q = torch.round(scores * MASK_QUANT).to(torch.int64)
        for i, (x0, y0) in enumerate(xy):
            fused[y0:y0 + p, x0:x0 + p] += q[i]
            count[y0:y0 + p, x0:x0 + p] += 1
        feats.append(emb)
    avg = fused.float() / (count.clamp(min=1) * MASK_QUANT).float()[..., None]
    avg = torch.where(count[..., None] > 0, avg, torch.zeros_like(avg))
    masks = (avg * 255.0).to(torch.uint8).cpu().numpy()
    return masks, torch.cat(feats), origins


def thresholds(masks: np.ndarray, itsc_q: float, road_q: float) -> dict:
    """The calibration rule: the keypoint and road masks' quantiles."""
    return dict(ITSC_THRESHOLD=float(np.quantile(masks[..., 0] / 255.0, itsc_q)),
                ROAD_THRESHOLD=float(np.quantile(masks[..., 1] / 255.0, road_q)))


def nms(points, scores, radius: float) -> np.ndarray:
    """Greedy radius NMS (graph_utils.py::nms_points): points visited in
    descending score order; each point still kept sets every point within
    `radius` (squared distance <= radius^2) to kept only if its score > 1.0,
    then stays kept itself. Returns the kept points in visiting order."""
    points = np.asarray(points, np.float64).reshape(-1, 2)
    scores = np.asarray(scores, np.float64).reshape(-1)
    if points.shape[0] == 0:
        return points
    order = np.argsort(scores)[::-1]
    pts, sc = points[order], scores[order]
    immune = sc > 1.0
    if immune.all():  # nothing can be suppressed
        return pts
    cell = radius if radius > 0 else 1.0
    cx = np.floor(pts[:, 0] / cell).astype(np.int64)
    cy = np.floor(pts[:, 1] / cell).astype(np.int64)
    ny = cy.max() - cy.min() + 3  # a spare row each side: dy = +-1 never wraps
    key = (cx - cx.min()) * ny + (cy - cy.min())
    by_cell = np.argsort(key, kind="stable")
    sorted_keys = key[by_cell]
    around = np.array([dx * ny + dy for dx in (-1, 0, 1) for dy in (-1, 0, 1)])
    kept = np.ones(len(pts), bool)
    r2 = radius * radius
    for i in range(len(pts)):
        if not kept[i]:
            continue
        ks = key[i] + around
        lo, hi = np.searchsorted(sorted_keys, ks), np.searchsorted(sorted_keys, ks + 1)
        near = np.concatenate([by_cell[a:b] for a, b in zip(lo, hi)])
        d = pts[near] - pts[i]
        hit = near[(d * d).sum(1) <= r2]
        kept[hit] = immune[hit]
        kept[i] = True
    return pts[kept]


def extract_vertices(masks: np.ndarray, cfg: dict) -> np.ndarray:
    """Vertices [N, 2] (x, y): keypoint and road pixels above their
    thresholds, each NMS'd, then unioned with keypoint priority and NMS'd
    at the road radius."""
    def candidates(mask, thr):
        above = mask > thr * 255
        return np.column_stack(np.where(above))[:, ::-1], mask[above]

    kp_xy, kp_s = candidates(masks[..., 0], cfg["ITSC_THRESHOLD"])
    road_xy, road_s = candidates(masks[..., 1], cfg["ROAD_THRESHOLD"])
    kps = nms(kp_xy, kp_s, cfg["ITSC_NMS_RADIUS"])
    roads = nms(road_xy, road_s, cfg["ROAD_NMS_RADIUS"])
    pri = np.concatenate([np.ones(len(kps)), np.zeros(len(roads))])
    return nms(np.concatenate([kps, roads]), pri, cfg["ROAD_NMS_RADIUS"])


def patch_pairs(vertices: np.ndarray, box, k: int, radius: float):
    """The vertices inside box (x0, y0, x1, y1, inclusive) by index, their
    patch-local coordinates, and each one's nearest neighbours among them
    strictly within `radius` (nearest first, ties by index): (ids [m],
    local [m, 2], nbr [m, k], valid [m, k])."""
    x0, y0, x1, y1 = box
    inside = ((vertices[:, 0] >= x0) & (vertices[:, 0] <= x1)
              & (vertices[:, 1] >= y0) & (vertices[:, 1] <= y1))
    ids = np.nonzero(inside)[0]
    local = (vertices[ids].astype(np.float32) - np.float32([x0, y0])).astype(np.float64)
    m = len(ids)
    nbr = np.zeros((m, k), np.int64)
    valid = np.zeros((m, k), bool)
    if m > 1:
        # every pair within the radius, both ways, ordered by (source,
        # squared distance, target); the first k of each source are kept
        ij = cKDTree(local).query_pairs(radius, output_type="ndarray")
        ij = np.concatenate([ij, ij[:, ::-1]])
        d2 = ((local[ij[:, 0]] - local[ij[:, 1]]) ** 2).sum(1)
        ij, d2 = ij[d2 < radius * radius], d2[d2 < radius * radius]
        order = np.lexsort((ij[:, 1], d2, ij[:, 0]))
        ij = ij[order]
        first = np.searchsorted(ij[:, 0], np.arange(m))
        rank = np.arange(len(ij)) - first[ij[:, 0]]
        take = rank < k
        nbr[ij[take, 0], rank[take]] = ij[take, 1]
        valid[ij[take, 0], rank[take]] = True
    return ids, local, nbr, valid


@torch.no_grad()
def edge_scores(sd, arch, feats, origins, vertices: np.ndarray, cfg: dict, device,
                prec=model.FP32, patches: list | None = None) -> dict:
    """Every directed pair (src, tgt) of vertex indices that some patch
    scored -> TopoNet's score averaged over those patches. Where `patches`
    is given, each patch that scored a pair appends its (sources, targets,
    scores) to it, in the grid's order."""
    p = cfg["PATCH_SIZE"]
    k, radius = cfg["MAX_NEIGHBOR_QUERIES"], float(cfg["NEIGHBOR_RADIUS"])
    keys, vals = [], []
    for i, (x0, y0) in enumerate(origins):
        ids, local, nbr, valid = patch_pairs(vertices, (x0, y0, x0 + p, y0 + p), k, radius)
        if len(ids) == 0 or not valid.any():
            continue
        pts = torch.from_numpy(local).float().to(device)[None]
        f = model.sample_points(feats[i:i + 1], pts, p)
        src = torch.arange(len(ids), device=device)[:, None].expand(-1, k)
        pairs = torch.stack([src, torch.from_numpy(nbr).to(device)], dim=-1)[None]
        v = torch.from_numpy(valid).to(device)[None]
        s = torch.sigmoid(model.toponet(sd, arch, pts, f, pairs, v, prec))[0].cpu().numpy()
        src_ids = np.broadcast_to(ids[:, None], nbr.shape)[valid]
        keys.append(src_ids * len(vertices) + ids[nbr][valid])
        vals.append(s[valid].astype(np.float64))
        if patches is not None:
            patches.append((src_ids, ids[nbr][valid], vals[-1]))
    if not keys:
        return {}
    keys, vals = np.concatenate(keys), np.concatenate(vals)
    uniq, inv = np.unique(keys, return_inverse=True)
    avg = np.bincount(inv, vals) / np.bincount(inv)
    n = len(vertices)
    return {(int(u // n), int(u % n)): float(a) for u, a in zip(uniq, avg)}
