"""Paired A/B of the training step: the eager encoder (K5) against
FUSED_ENCODER_TRAIN (K6: K1-K4 forwards with plain-recompute backwards),
interleaved in one process (counterpart of the repository's
tools/experiment_fused_train.py) at configs/toponet_vitb_512_cityscale.yaml,
batch 16, bf16, or at another `base` config.

Both arms start from one set of weights (`model`, or init_random of the
config), each on its own copy (load_state_dict) with its own Adam state,
and train on one fake batch staged on the device
(tools/_train.py::fake_batch); their dropout draws from one shared
generator in turn, as the JAX tool splits one key. Each arm takes a
warm-up step, then `rounds` rounds of `steps` steps, A then B in each
round, each timed by the host clock between two synchronises. Reported:
the warm-up losses, every round's s per step, the minima, the speedup
(eager / fused), patches a second, and per arm its losses and grad_norms,
its kernel launches, the max abs change of a few parameters, and the peak
device memory of the whole run (both arms resident).

Left out: the docstring's TPU target (0.30 s a step against the flax
step's 0.37). Nothing is caught.

    python -m sam_road_tpu_torch.tools.experiment_fused_train [--steps 8] [--rounds 3]
        [--remat] [--batch 16] [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import json
import time

from sam_road_tpu_torch.tools import _train, bench

CONFIG = "configs/toponet_vitb_512_cityscale.yaml"


class Arm:
    """One side of the A/B: its model copy, Adam, step, staged batch, and
    what its steps report."""

    def __init__(self, config, template, batch_np, device, deterministic: bool):
        from sam_road_tpu_torch.training.harness import materialize_batch

        self.model = _train.build_model(config, template)
        self.optimizer, self.step = _train.build_step(config, self.model, device,
                                                      deterministic=deterministic)
        self.batch = materialize_batch(batch_np, device)
        self.device = device
        self.before = _train.snapshot(self.model)
        self.logs: list = []
        self.launches: collections.Counter = collections.Counter()

    def run(self, gen, n: int) -> float:
        """n steps; seconds per step."""
        from sam_road_tpu_torch.ops import _build

        start = collections.Counter(_build.launches)
        bench.sync(self.device)
        t = time.perf_counter()
        for _ in range(n):
            self.logs.append(self.step(self.batch, gen))
        bench.sync(self.device)
        dt = (time.perf_counter() - t) / n
        self.launches.update(collections.Counter(_build.launches) - start)
        return dt

    def report(self) -> dict:
        return {"losses": [log["loss"] for log in self.logs],
                "grad_norms": [log["grad_norm"] for log in self.logs],
                "skipped": sum(log["skipped"] for log in self.logs),
                "launches": dict(self.launches), "moved": _train.moved(self.model, self.before)}


def main(steps: int = 8, rounds: int = 3, batch: int | None = 16, remat: bool = False,
         device: str = "cuda", *, base: str = CONFIG, overrides: dict | None = None,
         model=None, deterministic: bool = False) -> dict:
    """Returns and prints the A/B's JSON object. `base` (a config path;
    `batch` None for its BATCH_SIZE), `overrides`, `model` (weights carried
    across) and `deterministic` (dropout off) exist so that a caller can run
    the tool at another config or small."""
    import torch

    dev = bench.require_device(device)
    over = {"DP_SHARDS": 0, "DATA_WORKER_NUM": 0, **(overrides or {})}
    if remat:
        over["REMAT_ENCODER"] = True
    cfg_a = _train.train_config(base, {}, batch, over)
    cfg_b = _train.train_config(base, {}, batch, {**over, "FUSED_ENCODER_TRAIN": True})
    template = model if model is not None else _train.build_model(cfg_a)
    B = int(cfg_a.BATCH_SIZE)
    batch_np = _train.fake_batch(cfg_a, B)
    bench.reset_peak(dev)
    a = Arm(cfg_a, template, batch_np, dev, deterministic)
    b = Arm(cfg_b, template, batch_np, dev, deterministic)
    del template
    gen = torch.Generator(device=dev).manual_seed(_train.SEED)
    a.run(gen, 1)
    b.run(gen, 1)
    loss_a, loss_b = a.logs[0]["loss"], b.logs[0]["loss"]
    print(f"warmup losses: eager {loss_a:.4f} fused {loss_b:.4f}", flush=True)
    res_a, res_b = [], []
    for r in range(rounds):
        res_a.append(a.run(gen, steps))
        res_b.append(b.run(gen, steps))
        print(f"round {r}: eager {res_a[-1]:.4f} s/step, fused {res_b[-1]:.4f} s/step",
              flush=True)
    out = {
        "shape": f"{cfg_a.SAM_VERSION} {cfg_a.PATCH_SIZE}px B={B} {cfg_a.COMPUTE_DTYPE} "
                 f"remat={bool(cfg_a.REMAT_ENCODER)}",
        "warmup_losses": {"eager": loss_a, "fused": loss_b},
        "eager_s_per_step": res_a, "fused_s_per_step": res_b,
        "eager_min": min(res_a), "fused_min": min(res_b),
        "speedup": min(res_a) / min(res_b),
        "eager_patches_per_s": B / min(res_a), "fused_patches_per_s": B / min(res_b),
        "eager": a.report(), "fused": b.report(), "peak_gib": bench.peak_gib(dev),
        "device": bench.device_name(dev),
    }
    print(json.dumps(out), flush=True)
    del a, b
    _train.free(dev)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--remat", action="store_true", help="REMAT_ENCODER on for both arms")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args()
    main(args.steps, args.rounds, args.batch, args.remat, args.device)
