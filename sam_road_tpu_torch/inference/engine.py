"""Tiled region inference (counterpart of sam_road_tpu/inference/engine.py,
its plain single-device path).

  phase 1  upload the uint8 region once, crop each batch of patches on the
           device, run the encoder (fused kernels with FUSED_ENCODER) and
           the map decoder, fuse the masks as int32 fixed point (1/1024)
           and finalise to uint8 by truncation; the feature maps stay on
           the device;
  host     extract vertices (graph/extraction.py, native NMS) and build the
           per-patch pairs (inference/pairs.py, native kNN);
  phase 2  per batch: sample the cached features bilinearly, score the pairs
           with TopoNet, quantise the scores to int16 (-32768 for NaN); the
           host aggregates per edge in exact int64.

Phase-2 batches are dispatched before any score is fetched, so the device
scores batch i while the host builds the pairs of batch i + 1.

Config keys the port ignores, because they exist for a TPU behind a slow
host link or for meshes: INFER_STREAM_PHASE1 / _BANDS / _TAPER /
_SERIAL_UPLOAD, INFER_UPLOAD_BANDS, INFER_P2_SPECULATIVE / _SPEC_GUARD /
_PACK_ARGS / _DEVICE_AGG / _FETCH_WAVES, DP_SHARDS, SP_SHARDS and
FUSED_ENCODER_TRAIN. Streaming and device aggregation change no result in
the JAX engine (its masks and edges are bit-identical either way), so the
port's outputs are comparable with its default configuration.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sam_road_tpu_torch.data.partitions import get_patch_info_one_img
from sam_road_tpu_torch.graph.extraction import extract_graph_points
from sam_road_tpu_torch.inference.pairs import build_pairs_for_boxes
from sam_road_tpu_torch.models.fast_encoder import encoder_forward_fused

MASK_QUANT = 1024


def _bucket_size(x: int, minimum: int) -> int:
    """Next power of two >= max(x, minimum): phase 2 pads each batch's
    point groups to one of a few sizes, as the JAX engine does. Groups are
    scored independently, so the padding changes no score; it bounds the
    number of distinct phase-2 shapes."""
    size = max(int(minimum), 1)
    while size < x:
        size *= 2
    return size


class TiledInferenceEngine:
    """Whole-region inference with a fixed config and model."""

    def __init__(self, config, model, device, point_bucket: int = 64):
        self.config = config
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.point_bucket = point_bucket
        self.patch_size = int(config.PATCH_SIZE)
        self.batch_size = int(config.INFER_BATCH_SIZE)
        self.encoder = encoder_forward_fused if config.FUSED_ENCODER else None
        self.last_timings: dict = {}

    # ---------- phase 1 ----------

    @torch.no_grad()
    def _run_phase1(self, img: np.ndarray):
        """Dispatch phase 1 for a region; returns device tensors that may
        still be computing."""
        t0 = time.time()
        if img.ndim != 3 or img.shape[0] != img.shape[1] or img.shape[2] != 3:
            raise ValueError(f"region must be square HxWx3, got {img.shape}")
        if img.dtype != np.uint8:
            raise TypeError(f"region must be uint8, got {img.dtype}")
        cfg = self.config
        size = img.shape[0]
        p = self.patch_size
        infos = get_patch_info_one_img(0, size, cfg.SAMPLE_MARGIN, p,
                                       cfg.INFER_PATCHES_PER_EDGE)
        dev = self.device
        img_dev = torch.from_numpy(np.ascontiguousarray(img)).to(dev)
        fused = torch.zeros((size, size, 2), dtype=torch.int32, device=dev)
        counter = torch.zeros((size, size), dtype=torch.int32, device=dev)
        ar = torch.arange(p, device=dev)
        batches = []
        for b0 in range(0, len(infos), self.batch_size):
            info = infos[b0:b0 + self.batch_size]
            xy = np.array([i[1] for i in info], np.int64)
            x0s = torch.as_tensor(xy[:, 0], device=dev)
            y0s = torch.as_tensor(xy[:, 1], device=dev)
            rows = (y0s[:, None] + ar)[:, :, None]
            cols = (x0s[:, None] + ar)[:, None, :]
            rgb = img_dev[rows, cols].float()  # [b, p, p, 3] crops on device
            masks, feats = self.model.infer_masks_and_features(rgb, self.encoder)
            quant = torch.round(masks.float() * MASK_QUANT).to(torch.int32)
            for i, (x0, y0) in enumerate(xy.tolist()):
                fused[y0:y0 + p, x0:x0 + p] += quant[i]
                counter[y0:y0 + p, x0:x0 + p] += 1
            batches.append((feats, info))
        denom = (counter.clamp(min=1) * MASK_QUANT).float()
        avg = fused.float() / denom[..., None]
        avg = torch.where(counter[..., None] > 0, avg, torch.zeros_like(avg))
        masks_u8 = (avg * 255.0).to(torch.uint8)  # truncates, as the JAX engine
        return dict(batches=batches, masks=masks_u8, t0=t0)

    # ---------- phase 2 ----------

    @torch.no_grad()
    def _scores_q(self, feats, points, pairs, valid):
        """TopoNet scores as int16 fixed point (1/32767), -32768 for NaN."""
        s = self.model.infer_toponet(feats, points, pairs, valid).float()
        q = torch.round(s.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
        return torch.where(torch.isnan(s), torch.full_like(q, -(2 ** 15)), q)

    def _finish(self, p1: dict):
        """Host half: fetch masks, extract vertices, score and aggregate."""
        cfg = self.config
        t0 = p1["t0"]
        masks = p1["masks"].cpu().numpy()  # sync point
        kp_mask = np.ascontiguousarray(masks[..., 0])
        road_mask = np.ascontiguousarray(masks[..., 1])
        t1 = time.time()
        graph_points = extract_graph_points(kp_mask, road_mask, cfg)
        t2 = time.time()
        if graph_points.shape[0] == 0:
            self.last_timings = {"phase1": t1 - t0, "extract": t2 - t1,
                                 "phase2": 0.0, "total": time.time() - t0}
            return graph_points, np.zeros((0, 2), np.int64), kp_mask, road_mask

        max_nbr = int(cfg.MAX_NEIGHBOR_QUERIES)
        radius = float(cfg.NEIGHBOR_RADIUS)
        dev = self.device
        pending = []
        for feats, info in p1["batches"]:
            boxes = np.array([(x0, y0, x1, y1) for _, (x0, y0), (x1, y1) in info],
                             np.float64)
            per_patch = build_pairs_for_boxes(graph_points, boxes, max_nbr, radius)
            max_pts = max(pp[1].shape[0] for pp in per_patch)
            if max_pts == 0:
                continue
            S = _bucket_size(max_pts, self.point_bucket)
            nb = len(info)
            bpoints = np.zeros((nb, S, 2), np.float32)
            btgt = np.zeros((nb, S, max_nbr), np.int64)
            bvalid = np.zeros((nb, S, max_nbr), bool)
            for i, (_, pts, pairs, valid) in enumerate(per_patch):
                n = pts.shape[0]
                bpoints[i, :n] = pts
                btgt[i, :n] = pairs[..., 1]
                bvalid[i, :n] = valid
            src = np.broadcast_to(np.arange(S)[None, :, None], btgt.shape)
            bpairs = np.stack([src, btgt], axis=-1)
            q = self._scores_q(feats, torch.from_numpy(bpoints).to(dev),
                               torch.from_numpy(bpairs).to(dev),
                               torch.from_numpy(bvalid).to(dev))
            pending.append((q, per_patch))  # dispatched; fetched below

        all_src, all_tgt, all_score = [], [], []
        for q_dev, per_patch in pending:
            q = q_dev[..., 0].cpu().numpy().astype(np.int64)
            for i, (pidx, pts, pairs, valid) in enumerate(per_patch):
                n = pts.shape[0]
                if n == 0 or not valid.any():
                    continue
                all_src.append(pidx[pairs[..., 0][valid]])
                all_tgt.append(pidx[pairs[..., 1][valid]])
                all_score.append(q[i, :n][valid])

        t3 = time.time()
        if not all_src:
            pred_edges = np.zeros((0, 2), dtype=np.int64)
        else:
            n_pts = np.int64(graph_points.shape[0])
            keys = np.concatenate(all_src) * n_pts + np.concatenate(all_tgt)
            sc = np.concatenate(all_score)
            uniq, inv = np.unique(keys, return_inverse=True)
            sum_q = np.zeros(uniq.shape[0], np.int64)
            nanc = np.zeros(uniq.shape[0], np.int64)
            counts = np.zeros(uniq.shape[0], np.int64)
            np.add.at(sum_q, inv, sc)
            np.add.at(nanc, inv, (sc == -(2 ** 15)).astype(np.int64))
            np.add.at(counts, inv, 1)
            # exact int64 sums; a NaN score counts as the reference's -100
            sums = ((sum_q + 32768 * nanc).astype(np.float64) / 32767.0
                    - 100.0 * nanc.astype(np.float64))
            avg = sums / counts.astype(np.float64)
            kept = uniq[avg > cfg.TOPO_THRESHOLD]
            pred_edges = np.stack([kept // n_pts, kept % n_pts], axis=1)
        self.last_timings = {"phase1": t1 - t0, "extract": t2 - t1,
                             "phase2": t3 - t2, "total": time.time() - t0}
        return graph_points[:, ::-1], pred_edges, kp_mask, road_mask

    # ---------- entry points ----------

    def infer_one_img(self, img: np.ndarray):
        """img [H, W, 3] uint8 (square) -> (pred_nodes [N, 2] (r, c),
        pred_edges [E, 2], keypoint mask uint8, road mask uint8)."""
        return self._finish(self._run_phase1(img))

    def infer_tiles(self, imgs):
        """Yields infer_one_img's results in order, dispatching tile i + 1's
        phase 1 before the host half of tile i."""
        prev = None
        for img in imgs:
            cur = self._run_phase1(img)
            if prev is not None:
                yield self._finish(prev)
            prev = cur
        if prev is not None:
            yield self._finish(prev)
