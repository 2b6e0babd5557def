"""Phase 2's device time at the bench's shapes, split (counterpart of the
repository's tools/profile_phase2.py).

One scoring batch as the engine dispatches it: B = INFER_BATCH_SIZE
patches' feature maps ([B, 32, 32, 256] bf16 at 512 px, the layout
`SAMRoad.infer_toponet` takes), S points a patch (the point bucket, an
argument), P = MAX_NEIGHBOR_QUERIES neighbours a point, random points,
targets and a valid mask at 0.6, all from np.random.default_rng(0). Three
nested stages:
  sampler     ops/sampling.py's bilinear sampler alone;
  toponet     `model.infer_toponet`: the sampler, TopoNet, fp32 scores;
  full_int16  `engine._scores_q` on the same batch in the engine's compact
              arguments (uint16 points, int16 targets, packed validity;
              `compact_inputs`): + their decode and the int16
              quantisation the engine fetches.

Timing: `utils/profiling.py::ms_per_call` (CUDA events around `iters`
calls; the host clock on the CPU), one warm call of each stage first, then
`rounds` rounds with the stages in turns; the least of each stage's rounds,
and every round. The JAX tool's scan inside one jit is left out.

    python -m sam_road_tpu_torch.tools.profile_phase2 [S] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from sam_road_tpu_torch.tools import bench
from sam_road_tpu_torch.utils.profiling import ms_per_call

STAGES = ("sampler", "toponet", "full_int16")


def make_inputs(engine, S: int, seed: int = 0):
    """(feats, points, pairs, valid) of one batch on the engine's device."""
    import torch

    cfg = engine.config
    B, P, patch = engine.batch_size, int(cfg.MAX_NEIGHBOR_QUERIES), engine.patch_size
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.normal(size=(B, patch // 16, patch // 16, 256))
                             .astype(np.float32)).to(engine.device, engine.model.dtype)
    points = rng.integers(0, patch, size=(B, S, 2)).astype(np.float32)
    tgt = rng.integers(0, S, size=(B, S, P))
    valid = rng.random(size=(B, S, P)) < 0.6
    src = np.broadcast_to(np.arange(S)[None, :, None], tgt.shape)
    pairs = np.stack([src, tgt], axis=-1)
    return (feats,) + tuple(torch.from_numpy(a).to(engine.device)
                            for a in (points, pairs, valid))


def compact_inputs(engine, inputs):
    """(feats, points, pairs, valid) as the engine ships them to
    `_scores_q`: points as uint16 (int16 bytes), the pairs' targets as
    int16, the validity np.packbits-packed."""
    feats, points, pairs, valid = inputs
    return (feats,) + engine._put(points.cpu().numpy().astype(np.uint16),
                                  pairs[..., 1].cpu().numpy().astype(np.int16),
                                  np.packbits(valid.cpu().numpy(), axis=-1))


def make_stages(engine, inputs) -> dict:
    from sam_road_tpu_torch.ops.sampling import bilinear_sample_points

    feats, points = inputs[:2]
    compact = compact_inputs(engine, inputs)
    return dict(zip(STAGES, (
        lambda: bilinear_sample_points(feats, points, engine.patch_size),
        lambda: engine.model.infer_toponet(*inputs),
        lambda: engine._scores_q(*compact))))


def main(S: int = 128, device: str = "cuda", *, iters: int = 20, rounds: int = 5, model=None,
         overrides: dict | None = None, seed: int = bench.SEED) -> dict:
    """Returns and prints {stage}_ms (the least of the rounds) and
    {stage}_ms_rounds. `model` and `overrides` (on top of the bench config)
    exist so that a test can run the tool small."""
    import torch

    dev = bench.require_device(device)
    engine = bench.make_engine(dev, overrides, model, seed)
    inputs = make_inputs(engine, S)
    stages = make_stages(engine, inputs)
    times = {name: [] for name in stages}
    with torch.no_grad():
        for name, fn in stages.items():
            fn()
            print(f"# {name}: ran", flush=True)
        for _ in range(rounds):
            for name, fn in stages.items():
                times[name].append(ms_per_call(fn, iters, dev))
    B, S_, P = inputs[3].shape
    results = {"device": bench.device_name(dev), "shape": {"B": B, "S": S_, "P": P}}
    for name, ts in times.items():
        results[name + "_ms"] = min(ts)
        results[name + "_ms_rounds"] = ts
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("S", type=int, nargs="?", default=128, help="points a patch (default 128)")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args()
    main(args.S, args.device)
