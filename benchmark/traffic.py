"""The general traffic generator: a mix is a JSON file under
benchmark/traffic/ whose "kind" names what it makes, and whose other keys
are its parameters. Everything is drawn from the run's seed, but for what a mix fixes.

  region  `regions` uint8 regions of `size` px, cycled by one closed-loop
          caller; the thresholds from the first region's masks by the
          calibration quantiles `itsc_quantile` and `road_quantile`. The
          weights come from the mix's `weights_seed`: with random weights
          they set the work (TopoNet's scores sit near the edge threshold,
          so one seed's weights keep a thousand edges a region and
          another's a hundred thousand), so every run gets the same work
          and its seed draws the regions.
  train   `batches` training batches in collate_batch's format at the
          configuration's PATCH_SIZE, BATCH_SIZE, TOPO_SAMPLE_NUM and
          MAX_NEIGHBOR_QUERIES, cycled in order. Within a batch the
          patches run from sparse to dense: keypoint, road and connected
          shares rise evenly over their ranges, so that each half of a
          batch has another loss and gradient than the whole (random
          patches of one density would not show a step that leaves half
          of its batch out). A traced run traces `traced_steps` steps.

make_region follows sam_road_tpu_torch/tools/bench.py::make_region (a
uniform uint8 image) and train_batches chip_smoke.py::train_batches, frozen
here so that the program's tools can change without moving the benchmark;
the per-patch point counts are one fixed set that each seed shuffles, so
every seed's batches carry the same work.
"""

from __future__ import annotations

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of a run's inputs."""
    return np.random.default_rng([seed % 2 ** 63, stream])


def make_region(gen: np.random.Generator, size: int) -> np.ndarray:
    """A uint8 region [size, size, 3]."""
    return gen.integers(0, 255, size=(size, size, 3), dtype=np.uint8)


def weights_seed(mix: dict, seed: int) -> int:
    """The seed of the state dict: the mix's `weights_seed` where it fixes
    one, else the run's."""
    return int(mix.get("weights_seed", seed))


def regions(mix: dict, seed: int) -> list:
    gen = rng(seed, 1)
    return [make_region(gen, int(mix["size"])) for _ in range(int(mix["regions"]))]


def collate(samples, point_bucket: int) -> dict:
    """collate_batch's format (sam_road_tpu_torch/data/dataset.py): points
    zero-padded to a multiple of point_bucket (at least one), rgb uint8,
    masks uint8 round(v * 255), the rest stacked."""
    max_pts = max(s["graph_points"].shape[0] for s in samples)
    padded = max(point_bucket, -(-max_pts // point_bucket) * point_bucket)
    out = {}
    for key in samples[0]:
        if key == "graph_points":
            out[key] = np.stack([np.pad(s[key], ((0, padded - s[key].shape[0]), (0, 0)))
                                 for s in samples])
        elif key == "rgb":
            out[key] = np.stack([s[key] for s in samples]).astype(np.uint8)
        elif key in ("keypoint_mask", "road_mask"):
            out[key] = np.stack([np.round(s[key] * 255.0) for s in samples]).astype(np.uint8)
        else:
            out[key] = np.stack([s[key] for s in samples])
    return out


def train_batches(mix: dict, cfg: dict, seed: int) -> list:
    """`batches` batches: per patch a uint8 image, keypoint and road masks,
    a point count from the mix's fixed set, TOPO_SAMPLE_NUM source points
    each with MAX_NEIGHBOR_QUERIES targets, valid pairs at the mix's share
    and connected ones among them, the first pair of every patch valid;
    the i-th patch of a batch takes the i-th of B even steps over each
    [low, high] share range."""
    p, B = int(cfg["PATCH_SIZE"]), int(cfg["BATCH_SIZE"])
    S, K = int(cfg["TOPO_SAMPLE_NUM"]), int(cfg["MAX_NEIGHBOR_QUERIES"])
    n_batches = int(mix["batches"])
    lo, hi = mix["points_per_patch"]
    sizes = np.random.default_rng(0).integers(lo, hi + 1, n_batches * B)
    gen = rng(seed, 2)
    sizes = gen.permutation(sizes)
    batches = []
    for b in range(n_batches):
        samples = []
        for i in range(B):
            n_pts = int(sizes[b * B + i])
            kp, road, conn = (lo_s + (hi_s - lo_s) * i / max(B - 1, 1) for lo_s, hi_s in
                              (mix["keypoint_share"], mix["road_share"], mix["connected_share"]))
            src = gen.integers(0, n_pts, (S, 1))
            pairs = np.stack([np.broadcast_to(src, (S, K)), gen.integers(0, n_pts, (S, K))], -1)
            valid = gen.random((S, K)) < mix["valid_share"]
            valid[0, 0] = True
            samples.append(dict(
                rgb=gen.integers(0, 256, (p, p, 3), dtype=np.uint8),
                keypoint_mask=(gen.random((p, p)) < kp).astype(np.float32),
                road_mask=(gen.random((p, p)) < road).astype(np.float32),
                graph_points=gen.uniform(0, p, (n_pts, 2)).astype(np.float32),
                pairs=pairs.astype(np.int32),
                connected=(gen.random((S, K)) < conn) & valid,
                valid=valid,
            ))
        batches.append(collate(samples, int(mix["point_bucket"])))
    return batches
