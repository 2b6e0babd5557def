"""The eager encoder against the fused one in each of its modes, paired
(counterpart of the repository's tools/experiment_fused_encoder.py).

At the bench geometry (ViT-B, 512 px, B 32, bf16, seeded random weights, an
fp32 input from np.random.default_rng(0)): `eager` is models/vit.py's
encoder (every attention on K5), the others are
`models/fast_encoder.py::encoder_forward_fused` (K1-K4) under the module
switches each variant sets, every other switch at its default, and all of
them restored afterwards:
  v3         the defaults;
  v3pad      PAD_FREE off (the default, kept as the JAX tool's label);
  v3padfree  PAD_FREE (K7, K8);
  v3rj       WIN_ROLLED_ROWS (K10 rolled);
  v3g4 ... v3g32  WIN_GROUP_BATCH 4 / 8 / 16 / 32 (K10, G images a block).
Every variant's output is held to v3's (`bit_equal_to_v3`: the modes are
bit-equal on the card) and to the eager one's (`l1_diff_to_eager`, the sum
of |out - eager|, beside `l1`, the sum of |out|). Timing: one warm call of
each first, then `rounds` rounds of `utils/profiling.py::ms_per_call` over
`iters` calls, the variants in turns (every other round in reverse order);
each variant's least and every round, and the median over the rounds of
eager / variant (`paired_speedup_median`). The JAX tool's XLA_TAIL
variant (v3xt: plain XLA, no kernel) has no counterpart in the port; its
scan inside one jit is left out.

    python -m sam_road_tpu_torch.tools.experiment_fused_encoder [v3,v3g4,...] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics

import numpy as np

from sam_road_tpu_torch.tools import bench
from sam_road_tpu_torch.utils.profiling import ms_per_call

DEFAULTS = dict(PAD_FREE=False, WIN_GROUP_BATCH=1, WIN_ROLLED_ROWS=False)
VARIANTS = {
    "v3": {}, "v3pad": {"PAD_FREE": False}, "v3padfree": {"PAD_FREE": True},
    "v3rj": {"WIN_ROLLED_ROWS": True}, "v3g4": {"WIN_GROUP_BATCH": 4},
    "v3g8": {"WIN_GROUP_BATCH": 8}, "v3g16": {"WIN_GROUP_BATCH": 16},
    "v3g32": {"WIN_GROUP_BATCH": 32},
}


@contextlib.contextmanager
def encoder_switches(flags: dict):
    """models/fast_encoder.py's switches at DEFAULTS overlaid by `flags`
    inside the block; their previous values after it."""
    from sam_road_tpu_torch.models import fast_encoder as fe

    old = {k: getattr(fe, k) for k in DEFAULTS}
    for k, v in {**DEFAULTS, **flags}.items():
        setattr(fe, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(fe, k, v)


def main(variants: dict | None = None, device: str = "cuda", *, batch: int = 32,
         img_size: int = 512, sam_version: str = "vit_b", iters: int = 5, rounds: int = 5,
         seed: int = bench.SEED) -> dict:
    """Returns and prints {label}_ms, _ms_rounds, _l1, _l1_diff_to_eager,
    _bit_equal_to_v3 and _paired_speedup_median for `eager` and every
    variant (label -> switches; default VARIANTS, which must hold v3). The
    geometry arguments exist so that a test can run the tool small."""
    import torch

    from sam_road_tpu_torch.models.fast_encoder import encoder_forward_fused
    from sam_road_tpu_torch.models.sam_road import init_random
    from sam_road_tpu_torch.models.vit import ENCODER_SPECS, ImageEncoderViT

    variants = VARIANTS if variants is None else variants
    if "v3" not in variants:
        raise ValueError("the variants must hold v3, the one the others are held to")
    dev = bench.require_device(device)
    spec = ENCODER_SPECS[sam_version]
    enc = init_random(ImageEncoderViT(
        img_size=img_size, embed_dim=spec["embed_dim"], depth=spec["depth"],
        num_heads=spec["num_heads"], window_size=14,
        global_attn_indexes=spec["global_attn_indexes"], dtype=torch.bfloat16),
        seed).to(dev).eval()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(batch, img_size, img_size, 3))
                         .astype(np.float32)).to(dev)

    def runner(flags):
        if flags is None:
            return lambda: enc(x)

        def fn():
            with encoder_switches(flags):
                return encoder_forward_fused(enc, x)
        return fn

    runners = {"eager": runner(None), **{lb: runner(f) for lb, f in variants.items()}}
    results = {"device": bench.device_name(dev), "batch": batch, "img_size": img_size,
               "sam_version": sam_version}
    with torch.no_grad():
        outs = {}
        for lb, fn in runners.items():
            outs[lb] = fn()
            bench.sync(dev)
            print(f"# {lb}: ran", flush=True)
        ref = outs["eager"].float()
        for lb, out in outs.items():
            results[lb + "_l1"] = out.float().abs().sum().item()
            results[lb + "_l1_diff_to_eager"] = (out.float() - ref).abs().sum().item()
            if lb != "eager":
                results[lb + "_bit_equal_to_v3"] = torch.equal(out, outs["v3"])
        del outs, ref
        times = {lb: [] for lb in runners}
        for r in range(rounds):
            for lb in list(runners)[::(-1) ** r]:
                times[lb].append(ms_per_call(runners[lb], iters, dev))
            print("# round %d: %s" % (r, " ".join(f"{lb}={times[lb][-1]:.2f}ms"
                                                  for lb in runners)), flush=True)
    for lb, ts in times.items():
        results[lb + "_ms"] = min(ts)
        results[lb + "_ms_rounds"] = ts
        if lb != "eager":
            results[lb + "_paired_speedup_median"] = statistics.median(
                e / t for e, t in zip(times["eager"], ts))
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("only", nargs="?", default=None,
                    help="comma-separated variants (default all; v3 is always run)")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args()
    wanted = None if args.only is None else {"v3", *args.only.split(",")}
    main(None if wanted is None else {lb: f for lb, f in VARIANTS.items() if lb in wanted},
         args.device)
