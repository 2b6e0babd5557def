"""Training memory by FLASH_ATTENTION x REMAT_ENCODER (counterpart of the
repository's tools/experiment_train_memory.py): the whole train step
(forward, losses, gradients, grad_norm, the Adam update) at the flagship
training shape, ViT-B 512 px, batch 16 (argument), bf16, TOPO_SAMPLE_NUM
512, or at a `base` config's own geometry.

The JAX tool reads XLA's ahead-of-time memory analysis of the compiled
step; PyTorch runs eagerly and has none, so this tool measures the caching
allocator on the card instead. Per configuration, after one warm step (so
that Adam's moments exist) and with the gradients freed, as the step frees
them first:
  arg_mb   torch.cuda.memory_allocated before the measured steps: the
           parameters, Adam's state and the batch on the device (the
           arguments of the JAX step);
  peak_mb  torch.cuda.max_memory_allocated over the measured steps, after
           reset_peak_memory_stats;
  temp_mb  peak_mb - arg_mb: what the step itself holds at its peak
           (activations, gradients, workspace);
  out_mb   0: the update is in place, so the step returns nothing new.
On the CPU arg_mb is counted from the tensors (each parameter, Adam state
and batch tensor once) and the peaks are None. Each row also gives the
losses and grad_norms of the warm and measured steps, the kernel launches of
the measured steps and the max abs change of a few parameters.

Each configuration frees its model and optimizer before the next (del,
gc.collect, torch.cuda.empty_cache), so that peaks do not stack. Nothing is
caught (the JAX tool records "FAIL: ..." and goes on): a configuration that
does not fit ends the run with the allocator's error.

    python -m sam_road_tpu_torch.tools.experiment_train_memory [batch] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

from sam_road_tpu_torch.tools import _train, bench

# the JAX tool's geometry (on top of the package's defaults: vit_b, cityscale)
GEOMETRY = dict(PATCH_SIZE=512, COMPUTE_DTYPE="bfloat16", TOPO_SAMPLE_NUM=512,
                MAX_NEIGHBOR_QUERIES=16)


def state_bytes(model, optimizer, batch: dict) -> int:
    """Bytes of the parameters, Adam's state tensors and the batch, each
    storage counted once."""
    import torch

    seen, total = set(), 0
    tensors = list(model.parameters()) + list(batch.values())
    for state in optimizer.state.values():
        tensors += [t for t in state.values() if torch.is_tensor(t)]
    for t in tensors:
        key = (t.device, t.untyped_storage().data_ptr())
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def measure(config, device, steps: int = 1) -> dict:
    """One configuration's row (the module docstring)."""
    import torch

    from sam_road_tpu_torch.ops import _build
    from sam_road_tpu_torch.training.harness import materialize_batch

    model = _train.build_model(config)
    optimizer, step = _train.build_step(config, model, device)
    batch = materialize_batch(_train.fake_batch(config, int(config.BATCH_SIZE)), device)
    gen = torch.Generator(device=device).manual_seed(_train.SEED)
    before = _train.snapshot(model)
    logs = [step(batch, gen)]
    model.zero_grad(set_to_none=True)
    bench.reset_peak(device)
    cuda = device.type == "cuda"
    arg = torch.cuda.memory_allocated(device) if cuda else state_bytes(model, optimizer, batch)
    _build.reset_launches()
    for _ in range(steps):
        logs.append(step(batch, gen))
    bench.sync(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    row = {
        "arg_mb": arg / 2 ** 20, "peak_mb": None if peak is None else peak / 2 ** 20,
        "temp_mb": None if peak is None else (peak - arg) / 2 ** 20, "out_mb": 0.0,
        "batch": int(config.BATCH_SIZE), "losses": [log["loss"] for log in logs],
        "grad_norms": [log["grad_norm"] for log in logs],
        "skipped": sum(log["skipped"] for log in logs), "launches": dict(_build.launches),
        "moved": _train.moved(model, before),
    }
    del model, optimizer, step, batch
    _train.free(device)
    return row


def main(batch: int | None = 16, device: str = "cuda", *, base: str | None = None,
         overrides: dict | None = None, flash=(True, False), remat=(True, False),
         steps: int = 1) -> dict:
    """Returns and prints {"flash<f>_remat<r>": row, "device": ...}. `base`
    (a config path; its own geometry, `batch` None for its BATCH_SIZE),
    `overrides`, `flash`, `remat` and `steps` (measured after the warm one)
    exist so that a caller can run the tool at another geometry or small."""
    dev = bench.require_device(device)
    results = {"device": bench.device_name(dev)}
    for f in flash:
        for r in remat:
            cfg = _train.train_config(base, GEOMETRY, batch, {
                **(overrides or {}), "FLASH_ATTENTION": bool(f), "REMAT_ENCODER": bool(r)})
            label = f"flash{int(f)}_remat{int(r)}"
            results[label] = measure(cfg, dev, steps)
            print(f"# {label}: {json.dumps(results[label])}", flush=True)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", type=int, nargs="?", default=16)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args()
    main(args.batch, args.device)
