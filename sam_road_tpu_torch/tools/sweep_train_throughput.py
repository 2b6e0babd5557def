"""Training throughput over batch x REMAT_ENCODER (counterpart of the
repository's tools/sweep_train_throughput.py): the flagship train step
(ViT-B 512 px, bf16, TOPO_SAMPLE_NUM 512, FLASH_ATTENTION: the eager
encoder through K5) at B in 16, 32, 48, remat off and on.

Per configuration: a fresh model and Adam, one fake
batch staged on the device (tools/_train.py::fake_batch), 3 warm steps,
then `n_steps` steps timed by the host clock between two synchronises. A
row: config, batch, remat, s_per_step, patches_per_s (batch / s_per_step),
loss_finite, peak_gib (torch.cuda.max_memory_allocated over the timed
steps; None on the CPU) and the timed steps' kernel launches; the last line
is the best row by patches_per_s. Each configuration frees its model and
optimizer before the next.

Left out: the weather canary before and after (tools/device_canary.py is
the TPU's) and the TPU / A100 target floor of 58 patches a second, a
number derived for other hardware. Nothing is caught (the JAX tool records
an "error" row and goes on): a configuration that does not fit ends the
run.

    python -m sam_road_tpu_torch.tools.sweep_train_throughput [n_steps] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import time

from sam_road_tpu_torch.tools import _train, bench
from sam_road_tpu_torch.tools.experiment_train_memory import GEOMETRY

BATCHES = (16, 32, 48)
WARM_STEPS = 3


def run_config(config, device, n_steps: int = 8) -> dict:
    import torch

    from sam_road_tpu_torch.ops import _build
    from sam_road_tpu_torch.training.harness import materialize_batch

    b, remat = int(config.BATCH_SIZE), bool(config.REMAT_ENCODER)
    model = _train.build_model(config)
    optimizer, step = _train.build_step(config, model, device)
    batch = materialize_batch(_train.fake_batch(config, b), device)
    gen = torch.Generator(device=device).manual_seed(_train.SEED)
    for _ in range(WARM_STEPS):
        aux = step(batch, gen)
    bench.reset_peak(device)
    _build.reset_launches()
    t = time.perf_counter()
    for _ in range(n_steps):
        aux = step(batch, gen)
    bench.sync(device)
    dt = (time.perf_counter() - t) / n_steps
    row = {"config": f"B{b}_remat{int(remat)}", "batch": b, "remat": remat,
           "s_per_step": dt, "patches_per_s": b / dt,
           "loss_finite": math.isfinite(aux["loss"]) and math.isfinite(aux["grad_norm"]),
           "peak_gib": bench.peak_gib(device), "launches": dict(_build.launches)}
    del model, optimizer, step, batch
    _train.free(device)
    return row


def main(n_steps: int = 8, device: str = "cuda", *, batches=BATCHES,
         overrides: dict | None = None) -> dict:
    """Returns {"rows": [...], "best": row, "device": ...} and prints each
    row and the best. `batches` and `overrides` (on top of GEOMETRY) exist
    so that a caller can run the tool small."""
    dev = bench.require_device(device)
    rows = []
    for b in batches:
        for r in (False, True):
            cfg = _train.train_config(None, GEOMETRY, b,
                                      {**(overrides or {}), "REMAT_ENCODER": r})
            rows.append(run_config(cfg, dev, n_steps))
            print(json.dumps(rows[-1]), flush=True)
    best = max(rows, key=lambda row: row["patches_per_s"])
    print(json.dumps({"best": best}), flush=True)
    return {"rows": rows, "best": best, "device": bench.device_name(dev)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_steps", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args()
    main(args.n_steps, args.device)
