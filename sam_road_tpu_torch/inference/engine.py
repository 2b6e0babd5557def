"""Tiled region inference (counterpart of sam_road_tpu/inference/engine.py:
its single-device paths, its two mesh paths and its phase-2 modes).

  phase 1  crop each batch of patches out of the uint8 region on the
           device, run the encoder (fused kernels with FUSED_ENCODER, which
           LoRA and the SAM decoder refuse; else the eager encoder, K5) and
           the mask decoder, fuse the masks as int32 fixed point (1/1024)
           and finalise to uint8 by truncation; the feature maps stay on
           the device;
  host     extract vertices (graph/extraction.py over graph/nms.py's native
           NMS, whose grid holds only the suppressible candidates) and
           build the per-patch pairs (inference/pairs.py, native kNN);
  phase 2  per batch: sample the cached features bilinearly, score the pairs
           with TopoNet, quantise the scores to int16 (-32768 for NaN); the
           per-edge averages are exact int64 sums.

Phase 1 takes the first of these paths that applies (_run_phase1, in the
JAX engine's order):
  DP        (a mesh of n > 1 devices, SP_SHARDS 0) spatial banding: shard d
            takes a contiguous chunk of patch rows (band_assignment, as JAX's
            _band_assignment), runs its rounds of INFER_BATCH_SIZE / n
            patches on its own device (K1-K4 there with FUSED_ENCODER) and
            fuses into an int32 band of band_h rows; the bands are added at
            their row offsets on the first shard's device. Phase 2 pools
            round r's slot j of every shard into one batch of
            INFER_BATCH_SIZE patches, scored on the first shard's device.
            None of the modes below applies to it, as in JAX.
  streamed  (INFER_STREAM_PHASE1, the default, where _stream_plan finds a
            split) the patch grid cut at patch-column boundaries into
            INFER_STREAM_BANDS bands of whole batches (INFER_STREAM_TAPER:
            the end bands about half an interior band wide). The region
            crosses to the device as disjoint column slabs; band i assembles
            its pixels from them, starts its accumulator from band i - 1's
            overlapping columns, runs its batches, and finalises the columns
            left of band i + 1's anchor, whose copy to the host starts at
            once. INFER_STREAM_SERIAL_UPLOAD keeps one slab upload in
            flight: slab i + 1 is sent after band i's dispatch, and the host
            waits for it. Under SP the band step runs the SP encoder.
  banded    (INFER_UPLOAD_BANDS > 1, one device) the region in that many row
            slabs, all sent before the first band runs; band i's batches
            crop from its slab and fuse into a slab-sized accumulator
            (partial batches padded with patches that fuse nowhere); the
            bands are added at their offsets.
  whole     one upload of the region, its batches in order.
  SP        (SP_SHARDS >= 1, a mesh of that many devices) is not a path of
            its own: every patch's encoder runs token-row sharded over the
            mesh (parallel/seq_parallel.py), FUSED_ENCODER off as in JAX, on
            the streamed or whole path, on the first shard's device.
            SP_SHARDS 1 is JAX's measurement mode: the SP machinery over one
            device.
Every path runs the same patches in batches of the same patches (DP and
banded: the same patches a batch in another grouping), and integer sums are
exact in any order, so each path's masks equal the whole path's bit for
bit wherever each patch's masks do.

Phase 2 (_dispatch_phase2, _collect_scores) as the JAX engine runs it:
  - compact arguments: uint16 points, int16 target indices and the validity
    as np.packbits bits; the device rebuilds the source indices (the row)
    and unpacks the bits (_scores_q);
  - every batch is dispatched before any score is fetched, so the device
    scores batch i while the host builds the pairs of batch i + 1;
  - one stacked copy to the host per distinct score shape, cut to the real
    point count rounded up to 32; INFER_P2_FETCH_WAVES splits a shape's
    batches into that many waves in dispatch order;
  - INFER_P2_PACK_ARGS: one upload per kind of argument for every batch,
    sliced per batch on the device;
  - INFER_P2_DEVICE_AGG (one device, no SP): the host numbers the unique
    directed edges (uint16 vertex-id halves) and sends every slot's edge id
    in one upload; each batch adds (score, 1, is-NaN) into an int32
    [E_pad + 1, 3] accumulator (invalid slots into the E_pad row) by
    index_add_, fetched once and decoded as the host path decodes. Regions
    of _AGG_MAX_VERTS vertices or more, or with E_pad > _AGG_MAX_EDGE_PAD,
    fall back to the host aggregation and say so;
  - INFER_P2_SPECULATIVE (streamed, one device, no SP, neither of the two
    above): after phase 1's dispatch, wait for every mask chunk but the
    last, extract provisional vertices from them and dispatch the batches
    whose patches end INFER_P2_SPEC_GUARD px (0: 2 * ROAD_NMS_RADIUS) left
    of the last band's anchor; _finish takes such a batch's scores only
    where its pair arguments equal the final ones byte for byte, and
    dispatches it again otherwise.
No mode changes a result: the outputs equal the default path's bit for bit.
`last_timings` holds the JAX engine's keys, each the region's own host
seconds: phase1 (its dispatch and its wait for the masks), extract, phase2
(the pairs built, scored and fetched), total (phase1 + extract + phase2 +
aggregate; no total where no vertex is found) and the phase-2 split
p2_build / p2_dispatch / p2_fetch, with spec_* where speculation ran; and
the port's TIMING_KEYS. Under infer_tiles region i + 1's phase 1 is
dispatched before region i's host half, and each region still counts only
its own. Every timer is a span of utils/profiling.py, so a torch.profiler
trace shows the same blocks by name:
  engine.phase1            _run_phase1: phase 1's host dispatch
  engine.fetch_masks       the host blocked on phase 1's mask copies
  engine.extract           extract_graph_points (extract.threshold,
                           extract.nms_keypoint, extract.nms_road,
                           extract.nms_final)
  engine.phase2            engine.p2.build (pairs.knn, pairs.pack),
                           engine.p2.dispatch, engine.p2.fetch (the stacked
                           copies), engine.p2.collect (their decode)
  engine.aggregate         _aggregate_edges (aggregate.unique,
                           aggregate.sums), or the device aggregation's
                           decode
  engine.spec              _speculate_phase2 (engine.spec.wait,
                           engine.spec.extract)

On CUDA the streamed and banded slabs go through pinned host buffers on a
copy stream of their own, which the compute stream waits for by events,
and the mask chunks come back by non-blocking copies into pinned buffers,
each read after its event. On the CPU, which the caller names, the same
logic runs with ordinary copies. FUSED_ENCODER_TRAIN is a training key:
the engine does not read it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sam_road_tpu_torch.data.partitions import get_patch_info_one_img
from sam_road_tpu_torch.graph import nms
from sam_road_tpu_torch.graph.extraction import extract_graph_points
from sam_road_tpu_torch.inference.pairs import build_pairs_for_boxes
from sam_road_tpu_torch.models.fast_encoder import encoder_forward_fused
from sam_road_tpu_torch.ops import _build
from sam_road_tpu_torch.parallel.mesh import on_device, replicate, replicated_sharding
from sam_road_tpu_torch.parallel.seq_parallel import make_sp_encoder_body
from sam_road_tpu_torch.utils.profiling import span

MASK_QUANT = 1024
NAN_Q = -(2 ** 15)  # the int16 score of a NaN

# The device aggregation sends vertex ids and edge ids as uint16; larger
# regions fall back to the host aggregation (module-level, so that tests
# can lower them, as the JAX engine's tests do).
_AGG_MAX_VERTS = 65536
_AGG_MAX_EDGE_PAD = 65535

# last_timings' keys beyond the JAX engine's, a region's own:
#   p1_dispatch  host seconds of _run_phase1 (engine.phase1)
#   mask_wait    host seconds blocked on the mask copies (engine.fetch_masks)
#   aggregate    host seconds of the edge aggregation (engine.aggregate)
#   launches     the port's kernel launches (ops/_build.py::launches) in
#                the region's _run_phase1 and _finish
#   p1_device    CUDA only: seconds between two events on the compute
#                stream, before phase 1's first launch and after its last
#                mask chunk's copy to the host was queued. Phase 1's span
#                on the stream: it includes the stream's stalls on the slab
#                uploads and on the host's enqueue.
#   nms_candidates    points into the extraction's NMS passes
#   nms_suppressible  of them, those in the NMS grid (score <= 1.0; with
#                     uint8 masks the final pass's input alone)
#                     (graph/nms.py::counts)
TIMING_KEYS = ("p1_dispatch", "mask_wait", "aggregate", "launches", "p1_device",
               "nms_candidates", "nms_suppressible")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


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


class _Args(NamedTuple):
    """One batch's phase-2 pairs and compact arguments (_build_args)."""
    per_patch: list  # build_pairs_for_boxes's (pidx, pts, pairs, valid), a patch each
    points: np.ndarray  # uint16 [b, S, 2]
    tgt: np.ndarray  # int16 [b, S, K]
    valid_packed: np.ndarray  # uint8 [b, S, ceil(K / 8)], np.packbits
    S: int
    valid: np.ndarray  # bool [b, S, K]


class _SpecEntry(NamedTuple):
    """A speculative batch: its int16 scores on the device and the
    arguments they were dispatched with."""
    q: torch.Tensor
    points: np.ndarray
    tgt: np.ndarray
    valid_packed: np.ndarray
    S: int


def _as_int16(a: np.ndarray) -> torch.Tensor:
    """A uint16 host array as the int16 tensor of the same bytes (torch's
    uint16 has few operations); _uint16 reads it back."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16))


def _uint16(t: torch.Tensor) -> torch.Tensor:
    """The uint16 values of an int16 tensor of uint16 bytes, as int64."""
    return t.to(torch.int32).bitwise_and(0xFFFF).long()


def _unpack_bits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """np.unpackbits(packed, -1)[..., :n] as bool, on packed's device (bits
    big-endian within a byte: np.packbits's layout)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :n].bool()


class _HostCopy:
    """A device tensor's copy to the host, started at construction. On
    CUDA: a non-blocking copy into a pinned buffer on the current stream,
    read only after its event; on the CPU the tensor itself."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type == "cuda":
            self.buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.buf.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.buf = t

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.buf.numpy()


class _Uploads:
    """Host arrays to `device`. On CUDA each goes through a pinned host
    buffer and a non-blocking copy on a stream of its own, allocated there
    and recorded for the compute stream; `use` makes the compute stream
    wait for it. On the CPU the array itself."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(self, a: np.ndarray):
        """Starts a's copy; returns (tensor, event or None)."""
        if self.stream is None:
            return torch.from_numpy(np.ascontiguousarray(a)), None
        pinned = torch.empty(a.shape, dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype,
                             pin_memory=True)
        pinned.numpy()[...] = a
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            t = torch.empty(a.shape, dtype=pinned.dtype, device=self.device)
            t.copy_(pinned, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        t.record_stream(compute)
        return t, event

    @staticmethod
    def wait(upload) -> None:
        """The host waits until the upload has landed."""
        if upload[1] is not None:
            upload[1].synchronize()

    def use(self, upload) -> torch.Tensor:
        """The uploaded tensor, with the compute stream ordered after its copy."""
        t, event = upload
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
        return t


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
        self.uploads = _Uploads(self.device)
        self.last_timings: dict = {}
        # the device aggregation's last region: vertices, E, E_pad and the
        # path it took ("device" or "host")
        self.last_agg: dict | None = None

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
        """Dispatch phase 1 for a region; returns its batches, its uint8
        mask chunks on the device (column bands, left to right: one for
        every path but the streamed one) and their copies to the host,
        which may still be running; under "timings", its p1_dispatch
        seconds and launches, and on CUDA the events of its span on the
        compute stream."""
        launched = _build.launches.total()
        with span("engine.phase1") as s:
            p1 = self._phase1(img)
        p1["timings"] = dict(p1_dispatch=s.seconds, launches=_build.launches.total() - launched)
        return p1

    def _phase1(self, img: np.ndarray) -> dict:
        if img.ndim != 3 or img.shape[0] != img.shape[1] or img.shape[2] != 3:
            raise ValueError(f"region must be square HxWx3, got {img.shape}")
        if img.dtype != np.uint8:
            raise TypeError(f"region must be uint8, got {img.dtype}")
        cfg = self.config
        size = img.shape[0]
        infos = get_patch_info_one_img(0, size, cfg.SAMPLE_MARGIN, self.patch_size,
                                       cfg.INFER_PATCHES_PER_EDGE)
        B = self.batch_size
        spec = plan = None
        with on_device(self.device):
            events = self._stream_event()
            if self.n_shards > 1:
                batches, masks = self._phase1_banded(
                    torch.from_numpy(np.ascontiguousarray(img)), infos)
                chunks, copies = [masks], [_HostCopy(masks)]
            elif (bool(cfg.INFER_STREAM_PHASE1) and len(infos) > B
                  and (plan := self._stream_plan(infos, size,
                                                 int(cfg.INFER_STREAM_BANDS or 2))) is not None):
                batches, chunks, copies = self._phase1_streamed(img, infos, plan)
            elif self.sp_shards < 1 and int(cfg.INFER_UPLOAD_BANDS or 1) > 1 and len(infos) > B:
                batches, masks = self._phase1_banded_upload(img, infos,
                                                            int(cfg.INFER_UPLOAD_BANDS))
                chunks, copies = [masks], [_HostCopy(masks)]
            else:
                batches, masks = self._phase1_whole(img, infos)
                chunks, copies = [masks], [_HostCopy(masks)]
            if events is not None:
                events = (events, self._stream_event())
            if (plan is not None and bool(cfg.INFER_P2_SPECULATIVE) and len(plan) >= 2
                    and self.sp_shards < 1 and not bool(cfg.INFER_P2_PACK_ARGS)
                    and not bool(cfg.INFER_P2_DEVICE_AGG)):
                spec = self._speculate_phase2(plan, batches, copies)
        return dict(image_size=size, batches=batches, masks=tuple(chunks), copies=copies,
                    plan=plan, spec=spec, events=events)

    def _stream_event(self):
        """A timing event recorded now on the compute stream (CUDA), or None."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def _phase1_whole(self, img, infos):
        """One upload of the region, then its batches in order."""
        img_dev = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        return self._phase1_region(img_dev, infos)

    def _phase1_region(self, img_dev, infos):
        """The whole path's batches over a region already on the device:
        returns (batches, uint8 masks)."""
        dev, size = self.device, img_dev.shape[0]
        fused = torch.zeros((size, size, 2), dtype=torch.int32, device=dev)
        counter = torch.zeros((size, size), dtype=torch.int32, device=dev)
        batches = []
        for b0 in range(0, len(infos), self.batch_size):
            info = infos[b0:b0 + self.batch_size]
            xy = [i[1] for i in info]
            quant, feats = self._phase1_batch(self.model, img_dev, xy)
            _accumulate(fused, counter, quant, xy)
            batches.append((feats, info))
        return batches, _finalize(fused, counter)

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

    def _phase1_banded_upload(self, img, infos, n_bands: int):
        """INFER_UPLOAD_BANDS (JAX's _phase1_banded_upload): the patch rows
        in n_bands contiguous groups; each group's row slab (slab_h rows,
        the tallest group's span) is sent before the first band runs, so
        band i + 1's pixels cross while band i computes. Band i's rounds of
        B patches crop from its slab (slab-local rows; a partial round is
        padded with patches at (0, 0) that fuse nowhere) into a slab-sized
        accumulator; the bands are added at their row offsets."""
        B, p, dev = self.batch_size, self.patch_size, self.device
        H, W = img.shape[:2]
        rows = sorted({info[1][1] for info in infos})
        n_bands = max(1, min(n_bands, len(rows)))
        base, extra = divmod(len(rows), n_bands)
        groups, r = [], 0
        for d in range(n_bands):
            take = base + (1 if d < extra else 0)
            groups.append(set(rows[r:r + take]))
            r += take
        band_idxs = [[gi for gi, info in enumerate(infos) if info[1][1] in g] for g in groups]
        slab_h = max(max(infos[gi][1][1] for gi in ix) - min(infos[gi][1][1] for gi in ix) + p
                     for ix in band_idxs)
        offs, slabs = [], []
        for ix in band_idxs:
            y_lo = min(min(infos[gi][1][1] for gi in ix), H - slab_h)
            offs.append(y_lo)
            slabs.append(self.uploads.put(img[y_lo:y_lo + slab_h]))
        fused = torch.zeros((H, W, 2), dtype=torch.int32, device=dev)
        counter = torch.zeros((H, W), dtype=torch.int32, device=dev)
        batches = []
        for off, slab, ix in zip(offs, slabs, band_idxs):
            slab = self.uploads.use(slab)
            band = torch.zeros((slab_h, W, 2), dtype=torch.int32, device=dev)
            cnt = torch.zeros((slab_h, W), dtype=torch.int32, device=dev)
            for r0 in range(0, len(ix), B):
                sel = ix[r0:r0 + B]
                xy = [(infos[gi][1][0], infos[gi][1][1] - off) for gi in sel]
                quant, feats = self._phase1_batch(self.model, slab,
                                                  xy + [(0, 0)] * (B - len(xy)))
                _accumulate(band, cnt, quant, xy)
                batches.append((feats, [infos[gi] for gi in sel] + [None] * (B - len(sel))))
            fused[off:off + slab_h] += band
            counter[off:off + slab_h] += cnt
        return batches, _finalize(fused, counter)

    def _stream_plan(self, all_patch_info, image_size: int, n_bands: int = 2):
        """The streamed phase 1's bands (JAX's _stream_plan): the patch grid
        split at patch-column boundaries (patches are x-major) that leave
        every band whole batches. Returns [{i0, i1, a, e}] (patch index
        range, the accumulator's first column, its end column: band 0
        anchors at 0 and the last band ends at the image's edge, so the
        margins finalise with them), or None where no split exists or the
        first band would cover the image."""
        B, p = self.batch_size, self.patch_size
        n = len(all_patch_info)
        if n % B or n <= B:
            return None
        xs = sorted({info[1][0] for info in all_patch_info})
        if len(xs) < 2 or n % len(xs):
            return None
        per_col = n // len(xs)
        elig = [c for c in range(1, len(xs)) if (c * per_col) % B == 0]
        if not elig:
            return None
        k = max(2, min(int(n_bands), len(elig) + 1))
        if bool(self.config.INFER_STREAM_TAPER) and k >= 3:
            # the end bands about half an interior band (cumulative weights
            # 1, 2, ..., 2, 1): the first slab upload and the last chunk's
            # copy are the two ends nothing overlaps
            fracs = [(2 * j - 1) / (2 * k - 2) for j in range(1, k)]
        else:
            fracs = [j / k for j in range(1, k)]
        splits: list = []
        for f in fracs:
            cands = [c for c in elig if c not in splits]
            if not cands:
                break
            target = f * len(xs)
            splits.append(min(cands, key=lambda c: abs(c - target)))
        bounds = [0] + sorted(splits) + [len(xs)]
        bands = []
        for i in range(len(bounds) - 1):
            lo_col, hi_col = bounds[i], bounds[i + 1]
            a = 0 if i == 0 else xs[lo_col]
            e = image_size if hi_col == len(xs) else min(xs[hi_col - 1] + p, image_size)
            bands.append(dict(i0=lo_col * per_col, i1=hi_col * per_col, a=a, e=e))
        if bands[0]["e"] >= image_size:
            return None
        return bands

    def _phase1_streamed(self, img, infos, bands):
        """The streamed phase 1 over `bands` (_stream_plan): slab i holds
        pixel columns [e_{i-1}, e_i). Band i's accumulator covers columns
        [a, e); its first e_{i-1} - a columns start from band i - 1's, its
        batches crop at x0 - a from the band's pixels (the slab segments
        over [a, e), joined on the device), and the columns below band
        i + 1's anchor are final after it. Returns (batches, mask chunks,
        their host copies)."""
        W = img.shape[1]
        k = len(bands)
        slab_lo = [0] + [b["e"] for b in bands[:-1]]
        serial = bool(self.config.INFER_STREAM_SERIAL_UPLOAD)

        def put_slab(i):
            return self.uploads.put(img[:, slab_lo[i]:bands[i]["e"]])

        if serial:
            # one upload in flight: slab 0 now, slab i + 1 under band i
            slabs = [put_slab(0)] + [None] * (k - 1)
            self.uploads.wait(slabs[0])
        else:
            slabs = [put_slab(i) for i in range(k)]
        chunks, copies, batches = [], [], []
        prev = None  # (fused, counter, a) of the previous band
        for i, band in enumerate(bands):
            band_img = self._band_pixels(bands, slab_lo, slabs, i)
            end = bands[i + 1]["a"] if i + 1 < k else W
            part, chunk, prev = self._stream_band(band_img, band, infos, prev, end)
            batches += part
            chunks.append(chunk)
            copies.append(_HostCopy(chunk))
            if serial and i + 1 < k:
                slabs[i + 1] = put_slab(i + 1)
                self.uploads.wait(slabs[i + 1])
        return batches, chunks, copies

    def _band_pixels(self, bands, slab_lo, slabs, i):
        """Band i's pixel columns [a, e), joined on the device from the
        segments of the slab uploads (slab j: columns [slab_lo[j], e_j))
        that lie over them."""
        a, e = bands[i]["a"], bands[i]["e"]
        segs = []
        for j, lo in enumerate(slab_lo):
            hi = bands[j]["e"]
            if hi <= a or lo >= e:
                continue
            segs.append(self.uploads.use(slabs[j])[:, max(a - lo, 0):])
        return segs[0] if len(segs) == 1 else torch.cat(segs, dim=1)

    def _stream_band(self, band_img, band, infos, prev, end):
        """One band of the streamed phase 1: its accumulator over columns
        [a, e), the first columns started from `prev` (the previous band's
        (fused, counter, a), or None), its batches cropped from band_img at
        x0 - a, and the columns [a, end) finalised. Returns (its batches,
        the uint8 mask chunk, its (fused, counter, a) for the next band)."""
        B, dev = self.batch_size, self.device
        H = band_img.shape[0]
        a, e = band["a"], band["e"]
        fused = torch.zeros((H, e - a, 2), dtype=torch.int32, device=dev)
        counter = torch.zeros((H, e - a), dtype=torch.int32, device=dev)
        if prev is not None:
            # the previous band's columns [a, e_{i-1}) carry over
            p_fused, p_counter, p_a = prev
            seed_w = p_fused.shape[1] - (a - p_a)
            fused[:, :seed_w] = p_fused[:, a - p_a:]
            counter[:, :seed_w] = p_counter[:, a - p_a:]
        batches = []
        info = infos[band["i0"]:band["i1"]]
        for r0 in range(0, len(info), B):
            part = info[r0:r0 + B]
            xy = [(x0 - a, y0) for _, (x0, y0), _ in part]
            quant, feats = self._phase1_batch(self.model, band_img, xy)
            _accumulate(fused, counter, quant, xy)
            batches.append((feats, list(part)))
        chunk = _finalize(fused[:, :end - a], counter[:, :end - a])
        return batches, chunk, (fused, counter, a)

    # ---------- phase 2 ----------

    @torch.no_grad()
    def _scores_q(self, feats, points, tgt, valid_packed):
        """TopoNet scores as int16 fixed point (1/32767), -32768 for NaN,
        from the compact arguments: points [b, S, 2] (uint16 values as
        int16 bytes), tgt [b, S, K] int16, valid_packed [b, S, ceil(K / 8)]
        uint8 (np.packbits). The pairs' sources are the rows."""
        b, S, K = tgt.shape
        pts = _uint16(points).float()
        src = torch.arange(S, device=tgt.device).view(1, S, 1).expand(b, S, K)
        pairs = torch.stack([src, tgt.long()], dim=-1)
        valid = _unpack_bits(valid_packed, K)
        s = self.model.infer_toponet(feats, pts, pairs, valid).float()
        q = torch.round(s.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
        return torch.where(torch.isnan(s), torch.full_like(q, NAN_Q), q)

    @torch.no_grad()
    def _phase2_agg(self, feats, points, tgt, valid_packed, edge_ids, acc):
        """Score one batch and add (q, 1, q is NaN) of every slot into
        acc [E_pad + 1, 3] int32 at its edge id (edge_ids [b, S, K], uint16
        values as int16 bytes; invalid slots carry E_pad). Integer sums are
        exact in any order."""
        q = self._scores_q(feats, points, tgt, valid_packed)[..., 0].reshape(-1).to(torch.int32)
        vals = torch.stack([q, torch.ones_like(q), (q == NAN_Q).to(torch.int32)], dim=-1)
        acc.index_add_(0, _uint16(edge_ids).reshape(-1), vals)

    def _put(self, *arrays):
        """Compact phase-2 arguments on the engine's device: uint16 arrays
        as int16 bytes, the others as they are."""
        return tuple((_as_int16(a) if a.dtype == np.uint16 else torch.from_numpy(a))
                     .to(self.device) for a in arrays)

    def _build_args(self, info, graph_points) -> _Args | None:
        """One batch's pairs and compact arguments (JAX: engine.py:1126-1155),
        or None where no patch of the batch holds a point."""
        cfg = self.config
        max_nbr = int(cfg.MAX_NEIGHBOR_QUERIES)
        # None: a slot of a DP round past its shard's patches, or banded
        # padding: a degenerate box, no points
        with span("pairs.knn"):
            boxes = np.array([(0.0, 0.0, -1.0, -1.0) if e is None else (*e[1], *e[2])
                              for e in info], np.float64)
            per_patch = build_pairs_for_boxes(graph_points, boxes, max_nbr,
                                              float(cfg.NEIGHBOR_RADIUS))
        max_pts = max(pp[1].shape[0] for pp in per_patch)
        if max_pts == 0:
            return None
        S = _bucket_size(max_pts, self.point_bucket)
        if S >= 32768:
            raise ValueError(f"point bucket {S} exceeds the int16 pair index range")
        with span("pairs.pack"):
            nb = len(info)
            bpoints = np.zeros((nb, S, 2), np.uint16)
            btgt = np.zeros((nb, S, max_nbr), np.int16)
            bvalid = np.zeros((nb, S, max_nbr), bool)
            for i, (_, pts, pairs, valid) in enumerate(per_patch):
                n = pts.shape[0]
                bpoints[i, :n] = pts
                btgt[i, :n] = pairs[..., 1]
                bvalid[i, :n] = valid
            packed = np.packbits(bvalid, axis=-1)
        return _Args(per_patch, bpoints, btgt, packed, S, bvalid)

    def _speculate_phase2(self, plan, batches, copies):
        """INFER_P2_SPECULATIVE (JAX's _speculate_phase2): wait for the mask
        chunks of bands 0..k-2, extract provisional vertices from them and
        dispatch the scoring of each batch of those bands whose patches all
        end `guard` px left of the last band's anchor. Greedy NMS is
        global, so _finish uses an entry only where its pair arguments equal
        the final ones byte for byte."""
        cfg = self.config
        B = self.batch_size
        frontier = plan[-1]["a"]
        guard = int(cfg.INFER_P2_SPEC_GUARD or 0) or 2 * int(cfg.ROAD_NMS_RADIUS)
        entries = {}
        with span("engine.spec") as whole:
            with span("engine.spec.wait") as wait:
                chunks_np = [c.numpy() for c in copies[:-1]]
                prov = np.concatenate(chunks_np, axis=1)  # columns [0, frontier)
            with span("engine.spec.extract") as extract:
                prov_points = extract_graph_points(np.ascontiguousarray(prov[..., 0]),
                                                   np.ascontiguousarray(prov[..., 1]), cfg)
            # no provisional vertex: nothing to score
            n_spec = sum((b["i1"] - b["i0"]) // B for b in plan[:-1]) if prov_points.shape[0] else 0
            for bi in range(n_spec):
                feats, info = batches[bi]
                if any(e is not None and e[2][0] > frontier - guard for e in info):
                    continue
                args = self._build_args(info, prov_points)
                if args is None:
                    continue
                q = self._scores_q(feats, *self._put(args.points, args.tgt, args.valid_packed))
                entries[bi] = _SpecEntry(q, args.points, args.tgt, args.valid_packed, args.S)
        stats = {"spec_points": int(prov_points.shape[0]),
                 "spec_wait_s": round(wait.seconds, 4),
                 "spec_extract_s": round(extract.seconds, 4)}
        if prov_points.shape[0]:
            stats["spec_dispatched"] = len(entries)
        stats["spec_s"] = round(whole.seconds, 4)
        return {"entries": entries, "chunks_np": chunks_np, **stats}

    def _fetch_masks(self, p1: dict) -> np.ndarray:
        """The region's uint8 masks [H, W, 2] on the host: the chunks that
        speculation already read, then the rest, each after its copy. Then,
        on CUDA, phase 1's span on the stream into p1's p1_device."""
        done = p1["spec"]["chunks_np"] if p1.get("spec") else []
        parts = done + [c.numpy() for c in p1["copies"][len(done):]]
        if p1.get("events"):
            start, end = p1["events"]
            end.synchronize()  # recorded after the last copy: done by now
            p1["timings"]["p1_device"] = start.elapsed_time(end) * 1e-3
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)

    @torch.no_grad()
    def _finish(self, p1: dict):
        """Host half: fetch masks, extract vertices, score and aggregate.
        Sets last_timings (the module docstring) for p1's region."""
        launched = _build.launches.total()
        with span("engine.fetch_masks") as wait:
            masks = self._fetch_masks(p1)  # sync point
            kp_mask = np.ascontiguousarray(masks[..., 0])
            road_mask = np.ascontiguousarray(masks[..., 1])
        t = {**p1["timings"], "mask_wait": wait.seconds}
        counted = nms.counts.copy()
        with span("engine.extract", t, "extract"):
            graph_points = extract_graph_points(kp_mask, road_mask, self.config)
        t["nms_candidates"] = nms.counts["candidates"] - counted["candidates"]
        t["nms_suppressible"] = nms.counts["suppressible"] - counted["suppressible"]
        edges = self._phase2_and_aggregate(p1, graph_points, t)
        t["phase1"] = t["p1_dispatch"] + t["mask_wait"]
        t["launches"] += _build.launches.total() - launched
        t.setdefault("aggregate", 0.0)
        ours = {k: t[k] for k in TIMING_KEYS if k in t}
        if edges is None:  # no vertex: JAX's three keys
            self.last_timings = {"phase1": t["phase1"], "extract": t["extract"], "phase2": 0.0,
                                 **ours}
            return graph_points, np.zeros((0, 2), np.int64), kp_mask, road_mask
        self.last_timings = {
            "phase1": t["phase1"], "extract": t["extract"], "phase2": t["phase2"],
            "total": t["phase1"] + t["extract"] + t["phase2"] + t["aggregate"],
            **{k: round(v, 4) for k, v in t.items() if k.startswith(("p2_", "spec_"))}, **ours}
        return graph_points[:, ::-1], edges, kp_mask, road_mask

    def _phase2_and_aggregate(self, p1: dict, graph_points, t: dict):
        """Phase 2 and the aggregation of p1's region at graph_points:
        their seconds into t (phase2, p2_*, spec_*, aggregate). Returns the
        edges, or None where there is no vertex."""
        if graph_points.shape[0] == 0:
            return None
        spec = p1.get("spec")
        if spec is not None:
            t.update({k: v for k, v in spec.items() if k not in ("entries", "chunks_np")})
            t["spec_hits"] = 0
            t["spec_miss"] = 0
        with span("engine.phase2") as p2, on_device(self.device):
            pending, pred_edges = self._dispatch_phase2(p1["batches"], graph_points, t, spec)
            scored = self._collect_scores(pending, t)
        for k in ("p2_build", "p2_dispatch", "p2_fetch"):  # JAX's keys, whatever ran
            t.setdefault(k, 0.0)
        # the device aggregation decodes inside phase 2's span: aggregate
        t["phase2"] = p2.seconds - t.get("aggregate", 0.0)
        if pred_edges is None:  # the host aggregation
            with span("engine.aggregate", t, "aggregate"):
                pred_edges = self._aggregate_edges(scored, graph_points.shape[0])
        return pred_edges

    def _dispatch_phase2(self, batches, graph_points, fine: dict | None = None, spec=None):
        """Build each phase-1 batch's pairs on the host and dispatch its
        scoring, one batch after another (a speculative entry whose
        arguments match stands in for its dispatch); with
        INFER_P2_PACK_ARGS or INFER_P2_DEVICE_AGG every batch is built
        first. Adds the host seconds to `fine`'s p2_build / p2_dispatch (and
        p2_fetch and aggregate where the device aggregation runs; the
        speculation's hits and misses). Returns (pending: [(int16 scores
        on the device, per-patch pairs)], unfetched; the device
        aggregation's edges, or None where it did not run)."""
        cfg = self.config
        fine = {} if fine is None else fine
        entries = (spec or {}).get("entries", {})
        pack = bool(cfg.INFER_P2_PACK_ARGS) and self.n_shards == 1
        agg = bool(cfg.INFER_P2_DEVICE_AGG) and self.n_shards == 1 and self.sp_shards < 1
        self.last_agg = None
        if agg and graph_points.shape[0] >= _AGG_MAX_VERTS:
            print(f"[engine] INFER_P2_DEVICE_AGG: region has {graph_points.shape[0]} vertices "
                  f">= {_AGG_MAX_VERTS}; falling back to host edge aggregation", flush=True)
            self.last_agg = dict(vertices=int(graph_points.shape[0]), E=None, E_pad=None,
                                 path="host")
            agg = False
        pending, built = [], []
        for bi, (feats, info) in enumerate(batches):
            with span("engine.p2.build", fine, "p2_build"):
                args = self._build_args(info, graph_points)
            if args is None:
                continue
            if isinstance(feats, list):  # DP: the round's shards, pooled on the device
                feats = torch.cat([f.to(self.device) for f in feats])
            if pack or agg:
                built.append((feats, args))
                continue
            entry = entries.get(bi)
            if entry is not None:
                # the speculative scores stand only for identical arguments
                if (entry.S == args.S and np.array_equal(entry.points, args.points)
                        and np.array_equal(entry.tgt, args.tgt)
                        and np.array_equal(entry.valid_packed, args.valid_packed)):
                    pending.append((entry.q, args.per_patch))
                    fine["spec_hits"] += 1
                    continue
                fine["spec_miss"] += 1
            with span("engine.p2.dispatch", fine, "p2_dispatch"):
                pending.append((self._scores_q(feats, *self._put(args.points, args.tgt,
                                                                  args.valid_packed)),
                                args.per_patch))
        agg_edges = self._device_agg(built, graph_points.shape[0], fine) if agg and built else None
        if built and agg_edges is None:
            pending += self._dispatch_packed(built, fine)
        return pending, agg_edges

    def _dispatch_packed(self, built, fine: dict) -> list:
        """INFER_P2_PACK_ARGS (and the device aggregation's fall-back): one
        upload per kind of argument for every built batch, padded to the
        largest S, each batch's scoring on its slice."""
        with span("engine.p2.dispatch", fine, "p2_dispatch"):
            first = built[0][1]
            nb, S_max = len(built), max(args.S for _, args in built)
            b, K = first.tgt.shape[0], first.tgt.shape[-1]
            pk_pts = np.zeros((nb, b, S_max, 2), np.uint16)
            pk_tgt = np.zeros((nb, b, S_max, K), np.int16)
            pk_val = np.zeros((nb, b, S_max, first.valid_packed.shape[-1]), np.uint8)
            for i, (_, args) in enumerate(built):
                pk_pts[i, :, :args.S] = args.points
                pk_tgt[i, :, :args.S] = args.tgt
                pk_val[i, :, :args.S] = args.valid_packed
            dev_pts, dev_tgt, dev_val = self._put(pk_pts, pk_tgt, pk_val)
            return [(self._scores_q(feats, dev_pts[i, :, :args.S], dev_tgt[i, :, :args.S],
                                    dev_val[i, :, :args.S]), args.per_patch)
                    for i, (feats, args) in enumerate(built)]

    def _device_agg(self, built, n_points: int, fine: dict):
        """INFER_P2_DEVICE_AGG (JAX: engine.py:1187-1270): the unique
        directed edges of every valid slot, keyed src << 16 | tgt (the
        order of the host path's src * N + tgt), every slot's edge id in one
        upload, each batch's scores added on the device, one fetch. Returns
        the kept edges, or None where E_pad exceeds the uint16 ids."""
        cfg = self.config
        with span("engine.p2.build", fine, "p2_build"):
            keys_per, all_keys = [], []
            for _, args in built:
                b = args.tgt.shape[0]
                gp = np.zeros((b, args.S), np.uint16)
                for i, (pidx, pts, _, _) in enumerate(args.per_patch):
                    gp[i, :pts.shape[0]] = pidx
                gtgt = gp[np.arange(b)[:, None, None], args.tgt.astype(np.int64)]
                keys = (gp[:, :, None].astype(np.uint32) << 16) | gtgt.astype(np.uint32)
                keys_per.append(keys)
                all_keys.append(keys[args.valid])
            cat = np.concatenate(all_keys)
            if cat.size == 0:
                self.last_agg = dict(vertices=n_points, E=0, E_pad=None, path="device")
                return np.zeros((0, 2), dtype=np.int64)
            uniq = np.unique(cat)
            E = uniq.shape[0]
            E_pad = _bucket_size(E, 1024)
            self.last_agg = dict(vertices=n_points, E=int(E), E_pad=int(E_pad), path="device")
            if E_pad > _AGG_MAX_EDGE_PAD:
                print(f"[engine] INFER_P2_DEVICE_AGG: {E} unique edges exceed the uint16 "
                      "edge-id transport; falling back to host edge aggregation", flush=True)
                self.last_agg["path"] = "host"
                return None
            nb, S_max = len(built), max(args.S for _, args in built)
            b, K = built[0][1].tgt.shape[0], built[0][1].tgt.shape[-1]
            eids = np.full((nb, b, S_max, K), E_pad, np.uint16)
            for i, (_, args) in enumerate(built):
                eid = np.searchsorted(uniq, keys_per[i]).astype(np.uint16)
                eid[~args.valid] = E_pad
                eids[i, :, :args.S] = eid
        with span("engine.p2.dispatch", fine, "p2_dispatch"):
            (dev_eids,) = self._put(eids)
            acc = torch.zeros((E_pad + 1, 3), dtype=torch.int32, device=self.device)
            for i, (feats, args) in enumerate(built):
                self._phase2_agg(feats, *self._put(args.points, args.tgt, args.valid_packed),
                                 dev_eids[i, :, :args.S], acc)
        with span("engine.p2.fetch", fine, "p2_fetch"):
            acc_np = acc.cpu().numpy()  # one [E_pad + 1, 3] int32 fetch
        with span("engine.aggregate", fine, "aggregate"):
            sum_q = acc_np[:E, 0].astype(np.int64)
            cnt = np.maximum(acc_np[:E, 1].astype(np.float64), 1.0)
            nanc = acc_np[:E, 2].astype(np.int64)
            # the host path's decode: a NaN's -32768 out of the sum, -100 in
            sums = ((sum_q + 32768 * nanc).astype(np.float64) / 32767.0
                    - 100.0 * nanc.astype(np.float64))
            kept = uniq[sums / cnt > cfg.TOPO_THRESHOLD].astype(np.int64)
            if not kept.size:
                return np.zeros((0, 2), dtype=np.int64)
            return np.stack([kept >> 16, kept & 0xFFFF], axis=1)

    def _collect_scores(self, pending, fine: dict | None = None):
        """Fetch the pending int16 scores, one stacked copy per distinct
        shape (INFER_P2_FETCH_WAVES: per wave of that shape's batches, in
        dispatch order), each cut to its batches' real point count rounded
        up to 32, and keep the valid pairs': (source vertex, target vertex,
        score) arrays, one triple per patch with a valid pair. Adds the
        fetch's seconds to `fine`'s p2_fetch."""
        with span("engine.p2.fetch", fine, "p2_fetch"):
            by_shape: dict = {}
            for bi, (q, _) in enumerate(pending):
                by_shape.setdefault(tuple(q.shape), []).append(bi)
            waves = max(1, int(self.config.INFER_P2_FETCH_WAVES or 1))
            fetched = {}
            for shape, idxs in by_shape.items():
                if waves > 1 and len(idxs) >= 2 * waves:
                    parts = [[int(i) for i in s]
                             for s in np.array_split(np.asarray(idxs), waves) if len(s)]
                else:
                    parts = [idxs]
                for part in parts:
                    maxn = max((pp[1].shape[0] for bi in part for pp in pending[bi][1]),
                               default=0)
                    cut = min(shape[1], _round_up(max(maxn, 1), 32))
                    stacked = torch.stack([pending[bi][0] for bi in part])[:, :, :cut]
                    stacked = stacked.contiguous().cpu().numpy()
                    for j, bi in enumerate(part):
                        fetched[bi] = stacked[j]
        scored = []
        with span("engine.p2.collect"):
            for bi, (_, per_patch) in enumerate(pending):
                q = fetched[bi][..., 0].astype(np.int64)
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
        with span("aggregate.unique"):
            all_src, all_tgt, all_score = zip(*scored)
            n_pts = np.int64(n_points)
            keys = np.concatenate(all_src) * n_pts + np.concatenate(all_tgt)
            sc = np.concatenate(all_score)
            uniq, inv = np.unique(keys, return_inverse=True)
        with span("aggregate.sums"):
            sum_q = np.zeros(uniq.shape[0], np.int64)
            nanc = np.zeros(uniq.shape[0], np.int64)
            counts = np.zeros(uniq.shape[0], np.int64)
            np.add.at(sum_q, inv, sc)
            np.add.at(nanc, inv, (sc == NAN_Q).astype(np.int64))
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
