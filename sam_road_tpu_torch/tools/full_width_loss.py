"""The training loss at full width, held to the JAX package's numbers.

Workload: configs/toponet_vitb_512_cityscale.yaml (ViT-B, 512 px patches)
at COMPUTE_DTYPE float32, weights `init_random(SAMRoad.from_config(cfg), 0)`
(drawn from a CPU generator, so every machine builds the same ones), and
2 images of `_train.fake_batch` (np.random.default_rng(0)). One forward and
backward of `training/harness.py::loss_fn` on the eager model with dropout
off (`deterministic=True`): the mask loss, the topology loss, their sum and
the global gradient norm over every parameter, as the train step computes
it. On CUDA the encoder's attention runs K5's fp32 kernel
(csrc/folded_attention_f32.cu), 12 launches; TF32 is off for cuBLAS and
cuDNN, or the products keep about three digits.

full_width_loss.json, beside this file, holds the JAX package's four
numbers for the same weights and batch (the weights carried into a flax
tree by models/convert.py::to_flax_params; the losses composed as
sam_road_tpu/training/harness.py composes them), computed on the CPU by
`python tests/test_torch_full_width_loss.py --write`. main() compares the
port's numbers with them within TOLERANCE relative. `--tf32` is the
control: the same step with TF32 on for cuBLAS and cuDNN, a leak that the
check must see (it misses TOLERANCE).

    python -m sam_road_tpu_torch.tools.full_width_loss [--device cpu] [--tf32]
"""

from __future__ import annotations

import argparse
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "..", "..", "configs", "toponet_vitb_512_cityscale.yaml")
OVERRIDES = dict(COMPUTE_DTYPE="float32")
BATCH = 2
SEED = 0
REFERENCE = os.path.join(HERE, "full_width_loss.json")
KEYS = ("mask_loss", "topo_loss", "loss", "grad_norm")
# relative, between the sound readings and a TF32 leak: the fp32 step read at
# most 6.2e-7 on the card (three TF32 products in K5, fp32 in cuBLAS) and
# 2.7e-6 on the CPU (summed in another order than XLA's), while a product
# in TF32 keeps about three digits
TOLERANCE = 1e-5


def config():
    from sam_road_tpu_torch.config import load_config

    return load_config(CONFIG, overrides=OVERRIDES)


def inputs(cfg=None):
    """(config, seed-0 model on the CPU, the fake batch as numpy arrays)."""
    from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random
    from sam_road_tpu_torch.tools._train import fake_batch

    cfg = cfg or config()
    return cfg, init_random(SAMRoad.from_config(cfg), SEED), fake_batch(cfg, BATCH)


def step_numbers(cfg, model, batch, device) -> dict:
    """The four numbers of one forward and backward of `model` (on
    `device`) over `batch`."""
    import torch

    from sam_road_tpu_torch.training import harness

    model.zero_grad(set_to_none=True)
    loss, aux = harness.loss_fn(model, harness.materialize_batch(batch, device),
                                bool(cfg.FOCAL_LOSS), deterministic=True)
    loss.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    out = {k: float(v.item()) for k, v in aux.items()}
    out["grad_norm"] = float(torch.nn.utils.get_total_norm(grads).item())
    return out


def reference() -> dict:
    with open(REFERENCE) as f:
        return json.load(f)


def relative_errors(got: dict, want: dict) -> dict:
    return {k: abs(got[k] - want[k]) / abs(want[k]) for k in KEYS}


def main(device: str = "cuda", tf32: bool = False) -> dict:
    """Prints and returns {port, jax, rel_err, tolerance, ok, tf32,
    launches, seconds}: launches the kernels' counts over the step. `tf32`
    turns TF32 on for cuBLAS and cuDNN during the step (the control)."""
    import time

    import torch

    from sam_road_tpu_torch.ops import _build

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to run the plain versions")
    cfg, model, batch = inputs()
    model.to(dev)
    _build.reset_launches()
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        t = time.perf_counter()
        got = step_numbers(cfg, model, batch, dev)
        seconds = time.perf_counter() - t
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was
    want = reference()
    rel = relative_errors(got, want)
    result = {"port": got, "jax": {k: want[k] for k in KEYS}, "rel_err": rel,
              "tolerance": TOLERANCE, "ok": max(rel.values()) <= TOLERANCE, "tf32": tf32,
              "launches": dict(_build.launches), "seconds": seconds}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    ap.add_argument("--tf32", action="store_true",
                    help="TF32 on for cuBLAS and cuDNN: the control, which should miss")
    args = ap.parse_args()
    raise SystemExit(0 if main(args.device, args.tf32)["ok"] else 1)
