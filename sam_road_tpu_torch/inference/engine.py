"""Tiled region inference (counterpart of sam_road_tpu/inference/engine.py:
its single-device path and its two mesh paths).

  phase 1  upload the uint8 region once, crop each batch of patches on the
           device, run the encoder (fused kernels with FUSED_ENCODER, which
           LoRA and the SAM decoder refuse; else the eager encoder, K5) and
           the mask decoder, fuse the masks as int32 fixed point (1/1024)
           and finalise to uint8 by truncation; the feature maps stay on
           the device;
  host     extract vertices (graph/extraction.py, native NMS) and build the
           per-patch pairs (inference/pairs.py, native kNN);
  phase 2  per batch: sample the cached features bilinearly, score the pairs
           with TopoNet, quantise the scores to int16 (-32768 for NaN); the
           host aggregates per edge in exact int64.

Phase-2 batches are dispatched before any score is fetched, so the device
scores batch i while the host builds the pairs of batch i + 1.

With a mesh (parallel/mesh.py), one process drives every shard:
  DP       (a mesh of n > 1 devices, SP_SHARDS 0) spatial banding: shard d
           takes a contiguous chunk of patch rows (band_assignment, as JAX's
           _band_assignment), runs its rounds of INFER_BATCH_SIZE / n
           patches on its own device (K1-K4 there with FUSED_ENCODER) and
           fuses into an int32 band of band_h rows; the bands are added at
           their row offsets on the first shard's device. Integer sums are
           exact in any order, so the masks equal the single-device
           engine's bit for bit wherever each patch's masks do. Phase 2
           pools round r's slot j of every shard into one batch of
           INFER_BATCH_SIZE patches, scored on the first shard's device.
  SP       (SP_SHARDS >= 1, a mesh of that many devices) every patch's
           encoder runs token-row sharded over the mesh
           (parallel/seq_parallel.py); FUSED_ENCODER is turned off, as in
           JAX. The rest of the path is the single-device one, on the first
           shard's device. SP_SHARDS 1 is JAX's measurement mode: the SP
           machinery over one device.

Config keys the port ignores, because they exist for a TPU behind a slow
host link: INFER_STREAM_PHASE1 / _BANDS / _TAPER / _SERIAL_UPLOAD,
INFER_UPLOAD_BANDS, INFER_P2_SPECULATIVE / _SPEC_GUARD / _PACK_ARGS /
_DEVICE_AGG / _FETCH_WAVES, and FUSED_ENCODER_TRAIN. Streaming and device
aggregation change no result in the JAX engine (its masks and edges are
bit-identical either way), so the port's outputs are comparable with its
default configuration.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sam_road_tpu_torch.data.partitions import get_patch_info_one_img
from sam_road_tpu_torch.graph.extraction import extract_graph_points
from sam_road_tpu_torch.inference.pairs import build_pairs_for_boxes
from sam_road_tpu_torch.models.fast_encoder import encoder_forward_fused
from sam_road_tpu_torch.parallel.mesh import on_device, replicate, replicated_sharding
from sam_road_tpu_torch.parallel.seq_parallel import make_sp_encoder_body

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


def band_assignment(all_patch_info, image_size: int, n: int, patch_size: int):
    """Patch rows to n shards in contiguous near-equal chunks (the JAX
    engine's _band_assignment). Returns (per-shard patch-index lists, band
    row offsets [n], band_h)."""
    rows = sorted({info[1][1] for info in all_patch_info})
    base, extra = divmod(len(rows), n)
    row_dev, r = {}, 0
    for d in range(n):
        take = base + (1 if d < extra else 0)
        for y0 in rows[r:r + take]:
            row_dev[y0] = d
        r += take
    per_dev = [[] for _ in range(n)]
    for gi, info in enumerate(all_patch_info):
        per_dev[row_dev[info[1][1]]].append(gi)
    offs, band_h = [], patch_size
    for d in range(n):
        ys = [all_patch_info[gi][1][1] for gi in per_dev[d]]
        off = min(ys) if ys else 0
        offs.append(off)
        if ys:
            band_h = max(band_h, max(ys) - off + patch_size)
    return per_dev, offs, min(band_h, image_size)


def _accumulate(fused, counter, quant, xy, y_off: int = 0):
    """Add each patch's int32 masks quant[i] at its origin xy[i] (rows
    relative to y_off) and count it."""
    p = quant.shape[1]
    for i, (x0, y0) in enumerate(xy):
        y0 -= y_off
        fused[y0:y0 + p, x0:x0 + p] += quant[i]
        counter[y0:y0 + p, x0:x0 + p] += 1


def _finalize(fused, counter):
    """Average the fixed-point sums and truncate to uint8, as the JAX
    engine does."""
    denom = (counter.clamp(min=1) * MASK_QUANT).float()
    avg = fused.float() / denom[..., None]
    avg = torch.where(counter[..., None] > 0, avg, torch.zeros_like(avg))
    return (avg * 255.0).to(torch.uint8)


class TiledInferenceEngine:
    """Whole-region inference with a fixed config and model, on `device`,
    or with `mesh` over its devices (the first one holds the masks and runs
    phase 2; `device` is then unused)."""

    def __init__(self, config, model, device, point_bucket: int = 64, mesh=None):
        self.config = config
        self.mesh = mesh
        self.device = torch.device(device) if mesh is None else mesh.devices[0]
        self.model = model.to(self.device).eval()
        self.point_bucket = point_bucket
        self.patch_size = int(config.PATCH_SIZE)
        self.batch_size = int(config.INFER_BATCH_SIZE)
        self.sp_shards = int(config.SP_SHARDS or 0)
        fused = bool(config.FUSED_ENCODER)
        if self.sp_shards >= 1:
            # the JAX engine's checks (engine.py:91-103)
            if mesh is None or mesh.size != self.sp_shards:
                raise ValueError(f"SP_SHARDS={self.sp_shards} needs a mesh of that size, got "
                                 f"{None if mesh is None else mesh.size}")
            grid = self.patch_size // 16
            if grid % self.sp_shards:
                raise ValueError(f"token grid rows {grid} must divide by SP_SHARDS "
                                 f"{self.sp_shards}")
            self.n_shards = 1  # the mesh shards tokens, not patch rows
            if fused:
                print("FUSED_ENCODER disabled under SP_SHARDS: the sequence-parallel path "
                      "uses its own collective encoder", flush=True)
                fused = False
        else:
            self.n_shards = mesh.size if mesh is not None else 1
        if fused and (model.use_sam_decoder or model.lora_rank):
            # the JAX engine's assertion: the fused kernels read the plain
            # encoder's weights, and its decoder path is the map decoder's
            raise ValueError("FUSED_ENCODER supports the naive decoder without LoRA")
        if self.n_shards > 1 and self.batch_size % self.n_shards:
            raise ValueError(f"INFER_BATCH_SIZE {self.batch_size} must divide by mesh size "
                             f"{self.n_shards}")
        self.encoder = encoder_forward_fused if fused else None
        self.replicas = [self.model] if mesh is None else replicate(self.model, mesh)
        if self.sp_shards >= 1:
            self.encoder = self._sp_encoder()
        self.last_timings: dict = {}

    def _sp_encoder(self):
        """encoder(module, x) for infer_masks_and_features: x's pixel rows
        cut into SP_SHARDS bands, one on each mesh device, through the
        token-sharded body over every replica's encoder."""
        m = self.model
        body = make_sp_encoder_body(sam_version=m.sam_version, img_size=self.patch_size,
                                    window_size=m.image_encoder.window_size, dtype=m.dtype,
                                    n=self.sp_shards)
        encoders = [r.image_encoder for r in self.replicas]
        rows = self.patch_size // self.sp_shards

        def encoder(module, x):
            bands = [x[:, d * rows:(d + 1) * rows].to(dev)
                     for d, dev in enumerate(self.mesh.devices)]
            return body(encoders, bands)

        return encoder

    # ---------- phase 1 ----------

    def _crop(self, img_dev, xy):
        """The patches at the (x0, y0) origins `xy`, cropped on img_dev's
        device and converted to float: [b, p, p, 3]."""
        p = self.patch_size
        ar = torch.arange(p, device=img_dev.device)
        xy_t = torch.as_tensor(np.asarray(xy, np.int64).reshape(-1, 2), device=img_dev.device)
        rows = (xy_t[:, 1, None] + ar)[:, :, None]
        cols = (xy_t[:, 0, None] + ar)[:, None, :]
        return img_dev[rows, cols].float()

    def _phase1_batch(self, model, img_dev, xy):
        """Crops at the (x0, y0) origins `xy`, masks as int32 fixed point
        and the feature maps, on img_dev's device."""
        masks, feats = model.infer_masks_and_features(self._crop(img_dev, xy), self.encoder)
        return torch.round(masks.float() * MASK_QUANT).to(torch.int32), feats

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
        infos = get_patch_info_one_img(0, size, cfg.SAMPLE_MARGIN, self.patch_size,
                                       cfg.INFER_PATCHES_PER_EDGE)
        img_t = torch.from_numpy(np.ascontiguousarray(img))
        if self.n_shards > 1:
            batches, masks = self._phase1_banded(img_t, infos)
        else:
            dev = self.device
            img_dev = img_t.to(dev)
            fused = torch.zeros((size, size, 2), dtype=torch.int32, device=dev)
            counter = torch.zeros((size, size), dtype=torch.int32, device=dev)
            batches = []
            with on_device(dev):
                for b0 in range(0, len(infos), self.batch_size):
                    info = infos[b0:b0 + self.batch_size]
                    xy = [i[1] for i in info]
                    quant, feats = self._phase1_batch(self.model, img_dev, xy)
                    _accumulate(fused, counter, quant, xy)
                    batches.append((feats, info))
                masks = _finalize(fused, counter)
        return dict(batches=batches, masks=masks, t0=t0)

    def _phase1_banded(self, img_t, infos):
        """DP phase 1: every shard runs `rounds` rounds of b patches on its
        own device (slots past its patches crop (0, 0) and fuse nowhere, as
        JAX's weight-0 slots), fusing into its int32 band; round by round
        across the shards, so distinct cards overlap. Returns the pooled
        phase-2 batches (each a list of per-shard feature maps) and the
        masks on the first shard's device."""
        n, b = self.n_shards, self.batch_size // self.n_shards
        size = img_t.shape[0]
        devs = self.mesh.devices
        per_dev, offs, band_h = band_assignment(infos, size, n, self.patch_size)
        rounds = max(-(-len(g) // b) for g in per_dev)
        imgs = replicated_sharding(self.mesh)(img_t)
        bands = [torch.zeros((band_h, size, 2), dtype=torch.int32, device=d) for d in devs]
        cnts = [torch.zeros((band_h, size), dtype=torch.int32, device=d) for d in devs]
        feats = [[None] * rounds for _ in range(n)]
        for r in range(rounds):
            for d, dev in enumerate(devs):
                xy = [infos[gi][1] for gi in per_dev[d][r * b:(r + 1) * b]]
                with on_device(dev):
                    quant, feats[d][r] = self._phase1_batch(
                        self.replicas[d], imgs[d], xy + [(0, 0)] * (b - len(xy)))
                    _accumulate(bands[d], cnts[d], quant, xy, y_off=offs[d])
        # the band sum, on the first shard's device, then finalise there
        dev0 = devs[0]
        Hp = max(size, max(offs) + band_h)
        fused = torch.zeros((Hp, size, 2), dtype=torch.int32, device=dev0)
        counter = torch.zeros((Hp, size), dtype=torch.int32, device=dev0)
        for d, off in enumerate(offs):
            fused[off:off + band_h] += bands[d].to(dev0)
            counter[off:off + band_h] += cnts[d].to(dev0)
        masks = _finalize(fused[:size], counter[:size])
        # phase-2 batches: round r pools slot j of every shard
        batches = []
        for r in range(rounds):
            info = [infos[per_dev[d][j]] if j < len(per_dev[d]) else None
                    for d in range(n) for j in range(r * b, (r + 1) * b)]
            batches.append(([feats[d][r] for d in range(n)], info))
        return batches, masks

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

        pending = self._dispatch_phase2(p1["batches"], graph_points)
        scored = self._collect_scores(pending)
        t3 = time.time()
        pred_edges = self._aggregate_edges(scored, graph_points.shape[0])
        self.last_timings = {"phase1": t1 - t0, "extract": t2 - t1,
                             "phase2": t3 - t2, "total": time.time() - t0}
        return graph_points[:, ::-1], pred_edges, kp_mask, road_mask

    def _dispatch_phase2(self, batches, graph_points):
        """Build each phase-1 batch's pairs on the host and dispatch its
        scoring, one batch after another; returns [(int16 scores on the
        device, per-patch pairs)] for the batches with points, unfetched."""
        cfg = self.config
        max_nbr = int(cfg.MAX_NEIGHBOR_QUERIES)
        radius = float(cfg.NEIGHBOR_RADIUS)
        dev = self.device
        pending = []
        for feats, info in batches:
            # None: a slot of a DP round past its shard's patches, no points
            boxes = np.array([(0.0, 0.0, -1.0, -1.0) if e is None else (*e[1], *e[2])
                              for e in info], np.float64)
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
            if isinstance(feats, list):  # DP: the round's shards, pooled on dev
                feats = torch.cat([f.to(dev) for f in feats])
            q = self._scores_q(feats, torch.from_numpy(bpoints).to(dev),
                               torch.from_numpy(bpairs).to(dev),
                               torch.from_numpy(bvalid).to(dev))
            pending.append((q, per_patch))
        return pending

    @staticmethod
    def _collect_scores(pending):
        """Fetch each pending batch's int16 scores, in order, and keep the
        valid pairs': (source vertex, target vertex, score) arrays, one
        triple per patch with a valid pair."""
        scored = []
        for q_dev, per_patch in pending:
            q = q_dev[..., 0].cpu().numpy().astype(np.int64)
            for i, (pidx, pts, pairs, valid) in enumerate(per_patch):
                n = pts.shape[0]
                if n == 0 or not valid.any():
                    continue
                scored.append((pidx[pairs[..., 0][valid]], pidx[pairs[..., 1][valid]],
                               q[i, :n][valid]))
        return scored

    def _aggregate_edges(self, scored, n_points: int):
        """Average each (source, target) pair's scores in exact int64 and
        keep the edges above TOPO_THRESHOLD: [E, 2] vertex indices."""
        if not scored:
            return np.zeros((0, 2), dtype=np.int64)
        all_src, all_tgt, all_score = zip(*scored)
        n_pts = np.int64(n_points)
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
        kept = uniq[avg > self.config.TOPO_THRESHOLD]
        return np.stack([kept // n_pts, kept % n_pts], axis=1)

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
