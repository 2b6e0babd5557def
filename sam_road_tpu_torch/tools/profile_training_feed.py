"""How far the training input pipeline feeds the card (counterpart of the
repository's tools/profile_training_feed.py), at the flagship training
shape: ViT-B, 512 px patches, batch 16, bf16, TOPO_SAMPLE_NUM 128,
MAX_NEIGHBOR_QUERIES 16, over a generated SpaceNet-format fixture of
1024 px tiles (2 train, 1 val, 1 test, street spacing 64;
tools/_fixtures.py), so that label generation does representative
geometry work.

Measured:
  the device step   one loader batch fed `device_steps` times (10) through
                    training/harness.py::make_train_step, after a warm step:
                    device_step_ms, device_steps_per_s;
  the fed pipeline  for w in 1, 2, 4, 8: BatchLoader(num_workers=w,
                    prefetch=8) over `fed_batches` batches (16); the first
                    batch's step lets the producers start, the rest are
                    timed: steps_per_s_<w>w, and the loader's wait (the host
                    time in next() on the loader) summed over the timed
                    steps, loader_wait_s_<w>w, and a step,
                    loader_wait_per_step_s_<w>w;
  saturation_pct_8w 100 x steps_per_s_8w / device_steps_per_s (with the
                    largest worker count measured).
The producers are threads (data/dataset.py::BatchLoader), so their Python
work competes with the step's host side for the GIL; the wait and the rate
together say how much. Times are host-clock spans ending in a synchronise.

    python -m sam_road_tpu_torch.tools.profile_training_feed [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

from sam_road_tpu_torch.tools import _train, bench

FEED = dict(SAM_VERSION="vit_b", DATASET="spacenet", PATCH_SIZE=512, COMPUTE_DTYPE="bfloat16",
            BASE_LR=1e-3, TOPO_SAMPLE_NUM=128, MAX_NEIGHBOR_QUERIES=16)
WORKERS = (1, 2, 4, 8)


def timed_fed_steps(step, loader, gen, device):
    """One untimed step on the loader's first batch, then the rest timed:
    (steps, seconds, seconds waiting in next())."""
    it = iter(loader)
    step(next(it), gen)
    bench.sync(device)
    n, wait = 0, 0.0
    t = time.perf_counter()
    while True:
        tw = time.perf_counter()
        batch = next(it, None)
        wait += time.perf_counter() - tw
        if batch is None:
            break
        step(batch, gen)
        n += 1
    bench.sync(device)
    return n, time.perf_counter() - t, wait


def run(root: str, device, *, batch: int, image_size: int, overrides: dict,
        device_steps: int, fed_batches: int, workers) -> dict:
    import torch

    from sam_road_tpu_torch.config import load_config
    from sam_road_tpu_torch.data.dataset import BatchLoader, SatMapDataset
    from sam_road_tpu_torch.training.harness import materialize_batch

    cfg = load_config(overrides={**FEED, "IMAGE_SIZE": image_size, "BATCH_SIZE": batch,
                                 **overrides})
    model = _train.build_model(cfg)
    _, step = _train.build_step(cfg, model, device)
    ds = SatMapDataset(cfg, is_train=True, data_root=root)
    gen = torch.Generator(device=device).manual_seed(_train.SEED)
    results = {"device": bench.device_name(device), "batch": batch}

    b = materialize_batch(next(iter(BatchLoader(ds, batch, num_batches=1, num_workers=1))),
                          device)
    step(b, gen)
    bench.sync(device)
    t = time.perf_counter()
    for _ in range(device_steps):
        step(b, gen)
    bench.sync(device)
    step_s = (time.perf_counter() - t) / device_steps
    results.update(device_step_ms=step_s * 1e3, device_steps_per_s=1.0 / step_s)
    del b

    for w in workers:
        loader = BatchLoader(ds, batch, num_batches=fed_batches, num_workers=w, prefetch=8)
        n, seconds, wait = timed_fed_steps(step, loader, gen, device)
        results[f"steps_per_s_{w}w"] = n / seconds
        results[f"loader_wait_s_{w}w"] = wait
        results[f"loader_wait_per_step_s_{w}w"] = wait / n
        print(f"# {w} workers: {n} steps, {n / seconds:.3f} steps/s, loader wait "
              f"{wait:.3f} s", flush=True)
    top = max(workers)
    results[f"saturation_pct_{top}w"] = (100 * results[f"steps_per_s_{top}w"]
                                         / results["device_steps_per_s"])
    del model, step
    _train.free(device)
    return results


def main(device: str = "cuda", *, root: str | None = None, image_size: int = 1024,
         spacing: int = 64, batch: int = 16, overrides: dict | None = None,
         device_steps: int = 10, fed_batches: int = 16, workers=WORKERS) -> dict:
    """Writes the fixture (2 train, 1 val, 1 test tiles, under `root`, else a
    temporary directory), runs the measurements and prints and returns their
    JSON object. The tile size and spacing, `batch`, `overrides` (on top of
    FEED), the step and batch counts and `workers` exist so that a caller
    can run it small."""
    from sam_road_tpu_torch.tools._fixtures import make_spacenet_fixture

    dev = bench.require_device(device)
    with tempfile.TemporaryDirectory(prefix="feed_") as tmp:
        root = root or tmp
        t = time.perf_counter()
        make_spacenet_fixture(root, image_size=image_size, spacing=spacing)
        fixture_s = time.perf_counter() - t
        results = run(root, dev, batch=batch, image_size=image_size,
                      overrides=dict(overrides or {}), device_steps=device_steps,
                      fed_batches=fed_batches, workers=workers)
    results["fixture_s"] = fixture_s
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args()
    main(args.device)
