"""Training harness (counterpart of sam_road_tpu/training/harness.py):
Adam per parameter group, the train step with gradient clipping and the
non-finite guard, the eval step with streaming metrics, and checkpoints.

  encoder             BASE_LR * ENCODER_LR_FACTOR, or frozen (FREEZE_ENCODER
                      or ENCODER_LORA)
  encoder_lora        the LoRA adapters: BASE_LR with ENCODER_LORA
  decoder, toponet    BASE_LR (decoder: the map decoder or SAM's)
  schedule            x0.1 once 9 * steps_per_epoch updates were applied
                      (MultiStepLR at epoch 9; optax's piecewise constant
                      schedule over Adam's own count)

A frozen encoder keeps requires_grad and stays out of the optimizer: its
gradients are computed and count in grad_norm and in clipping, as the JAX
package's optax.set_to_zero group does. A trainable parameter that the
loss does not reach (the SAM decoder's iou head, computed and dropped as in
JAX) gets a zero gradient, as optax gives every leaf one, so Adam's step
counts stay equal across parameters. Parameters stay fp32 (the model
casts to the compute dtype at use), so gradients and Adam's moments are
fp32. With FUSED_ENCODER_TRAIN the training forward runs the encoder
through the K6 wrappers (_fused_forward: K1-K4 forward, plain-PyTorch
recompute backward); the eval step and the validation panels stay on the
eager model, as the JAX eval step stays on the flax model. REMAT_ENCODER
checkpoints each encoder block on both paths; it refuses LoRA and the SAM
decoder, as the JAX harness does.

Data parallelism (the JAX Trainer over its dp mesh) is one process per rank
under torch.distributed: where a process group is initialised, the Trainer
wraps the model in DistributedDataParallel, and each rank trains on its own
rows of the global batch (cli/train.py gives its loaders process_index /
process_count). What the JAX step computes over the global batch, the ranks
compute together:
  mask losses      means over equal local batches; DDP's gradient average
                   is the global mean's gradient;
  topology loss    divided by the global valid count over the world size
                   (one all-reduce before the forward), so the average is
                   the global masked mean's gradient where the ranks hold
                   different numbers of valid pairs;
  reported losses  all-reduced and averaged after the backward;
  grad_norm        taken on DDP's averaged gradients, then clipping and the
                   non-finite skip, so every rank takes the same decision
                   (a NaN on one rank reaches all through the reductions);
  validation       each rank's totals summed across ranks before dividing.
Adam's state stays replicated (DDP broadcasts rank 0's weights at the
start, and every rank applies the same update). Rank 0 alone prints, logs
and writes checkpoints.
"""

from __future__ import annotations

import itertools
import os
import time
from functools import partial

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from sam_road_tpu_torch.models.fast_encoder import encoder_forward_fused
from sam_road_tpu_torch.ops.losses import bce_with_logits, masked_topo_loss, sigmoid_focal_loss
from sam_road_tpu_torch.ops.metrics import binary_f1_counts, binary_iou_counts, pr_histogram
from sam_road_tpu_torch.utils.profiling import span
from sam_road_tpu_torch.utils.viz import save_val_visualizations


_END = object()  # the loader's end, for next()


def param_group(name: str) -> str:
    """Optimizer group of a parameter, by its top-level module (the JAX
    harness's _param_group)."""
    top = name.split(".", 1)[0]
    if top == "image_encoder":
        return "encoder_lora" if ("linear_a_" in name or "linear_b_" in name) else "encoder"
    if top == "topo_net":
        return "toponet"
    return "decoder"


def build_optimizer(config, model) -> torch.optim.Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8, as optax.adam) with one group per
    trained module group of param_group: encoder at BASE_LR *
    ENCODER_LR_FACTOR unless FREEZE_ENCODER or ENCODER_LORA freeze it,
    encoder_lora at BASE_LR with ENCODER_LORA (else frozen), decoder and
    toponet at BASE_LR. Frozen groups stay out of the optimizer. Each group
    keeps its unscheduled rate in "initial_lr" (apply_update schedules
    it)."""
    base_lr = float(config.BASE_LR)
    lrs = {"encoder": base_lr * float(config.ENCODER_LR_FACTOR), "encoder_lora": base_lr,
           "decoder": base_lr, "toponet": base_lr}
    frozen = set()
    if config.FREEZE_ENCODER or config.ENCODER_LORA:
        frozen.add("encoder")
    if not config.ENCODER_LORA:
        frozen.add("encoder_lora")
    groups: dict = {}
    for name, p in model.named_parameters():
        group = param_group(name)
        if group in frozen:
            continue
        groups.setdefault(group, []).append(p)
    return torch.optim.Adam(
        [{"params": ps, "lr": lrs[g], "initial_lr": lrs[g]} for g, ps in groups.items()],
        betas=(0.9, 0.999), eps=1e-8)


def applied_updates(optimizer) -> int:
    """Updates Adam has applied (its per-parameter step count)."""
    state = optimizer.state.get(optimizer.param_groups[0]["params"][0])
    return int(state["step"]) if state else 0


def apply_update(optimizer, boundary: int) -> None:
    """One Adam update at the scheduled rate: initial_lr before `boundary`
    applied updates, 0.1 x initial_lr from then on. Skipped steps apply
    nothing and do not count, as optax's count does not."""
    scale = 0.1 if applied_updates(optimizer) >= boundary else 1.0
    for group in optimizer.param_groups:
        group["lr"] = group["initial_lr"] * scale
    optimizer.step()


def materialize_batch(batch, device) -> dict:
    """collate_batch's arrays -> tensors on `device`: uint8 rgb becomes
    fp32 0-255 and uint8 masks fp32 0-1 there; float inputs pass
    through."""
    out = {}
    for key, val in batch.items():
        t = torch.as_tensor(val).to(device)
        if t.dtype == torch.uint8 and key == "rgb":
            t = t.float()
        elif t.dtype == torch.uint8 and key in ("keypoint_mask", "road_mask"):
            t = t.float() / 255.0
        out[key] = t
    return out


def _fused_forward(model, rgb, graph_points, pairs, valid, generator=None, remat=False,
                   deterministic=False):
    """SAMRoad.forward (normalise, encoder, MapDecoder, point sampling,
    TopoNet with dropout from `generator`) with the encoder routed through
    the differentiable fused forward (models/fast_encoder.py, the K6
    wrappers); remat checkpoints each encoder block. The same math as the
    eager model, held to it by the tests."""
    encoder = partial(encoder_forward_fused, differentiable=True, remat=remat)
    return model(rgb, graph_points, pairs, valid, deterministic=deterministic,
                 generator=generator, encoder=encoder)


def distributed() -> bool:
    """Whether a torch.distributed process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def loss_fn(model, batch, use_focal: bool, deterministic: bool = False, generator=None,
            fused: bool = False, remat: bool = False, topo_denominator=None):
    """Mask loss (BCE or focal) + masked topology BCE on a materialized
    batch, through the eager model or, with `fused`, _fused_forward;
    topo_denominator replaces the batch's valid count (masked_topo_loss).
    Returns (loss, {"mask_loss", "topo_loss", "loss"}), fp32."""
    args = (batch["rgb"], batch["graph_points"], batch["pairs"], batch["valid"])
    if fused:
        mask_logits, _, topo_logits, _ = _fused_forward(
            model, *args, generator, remat=remat, deterministic=deterministic)
    else:
        mask_logits, _, topo_logits, _ = model(*args, deterministic=deterministic,
                                               generator=generator)
    gt = torch.stack([batch["keypoint_mask"], batch["road_mask"]], dim=3)
    mask_loss = (sigmoid_focal_loss if use_focal else bce_with_logits)(mask_logits, gt)
    topo_loss = masked_topo_loss(topo_logits, batch["connected"], batch["valid"],
                                 topo_denominator)
    loss = mask_loss + topo_loss
    return loss, {"mask_loss": mask_loss, "topo_loss": topo_loss, "loss": loss}


def make_train_step(config, model, optimizer, steps_per_epoch: int, forward_model=None,
                    deterministic: bool = False):
    """train_step(batch, generator) -> aux: forward with dropout (through
    _fused_forward with FUSED_ENCODER_TRAIN; none where deterministic),
    loss, gradients, grad_norm over all of them, GRAD_CLIP_NORM scaling (off
    at 0), and the Adam update. A step whose loss or grad_norm is not finite
    changes neither the parameters nor Adam's state (aux["skipped"] = 1);
    checking costs one host sync per step. `forward_model` (the DDP wrapper
    of `model`, under a process group) runs the forward; the ranks then
    reduce as the module docstring says.

    The step's stages are spans (utils/profiling.py), in order:
    train.materialize, train.forward (the loss included), train.backward,
    train.grad_norm (zero-filled gradients, the norm, the clip),
    train.finite_sync, train.update, train.aux_sync, train.release (the
    loss's autograd graph and the batch freed, milliseconds at ViT-H's
    depth, which would otherwise fall between spans at the return).
    aux["wait_seconds"] is train.finite_sync + train.aux_sync: the host
    blocked on the card."""
    fused = bool(config.FUSED_ENCODER_TRAIN)
    if fused and config.USE_SAM_DECODER:
        raise ValueError("FUSED_ENCODER_TRAIN requires the naive map decoder "
                         "(USE_SAM_DECODER must be off)")
    if fused and config.ENCODER_LORA:
        raise ValueError("FUSED_ENCODER_TRAIN does not support ENCODER_LORA (the fused "
                         "forward consumes the plain SAM param tree)")
    remat = bool(config.REMAT_ENCODER)
    use_focal = bool(config.FOCAL_LOSS)
    clip_norm = float(config.GRAD_CLIP_NORM or 0.0)
    boundary = 9 * int(steps_per_epoch)
    params = list(model.parameters())
    device = params[0].device

    forward = model if forward_model is None else forward_model
    reduce = distributed()
    world = dist.get_world_size() if reduce else 1

    def train_step(batch, generator) -> dict:
        wait: dict = {}
        with span("train.materialize"):
            model.zero_grad(set_to_none=True)
            batch = materialize_batch(batch, device)
        with span("train.forward"):
            denom = None
            if reduce:  # the global valid count, as JAX's step over the global batch
                count = batch["valid"].sum(dtype=torch.float32)
                dist.all_reduce(count)
                denom = count.clamp(min=1.0) / world
            loss, aux = loss_fn(forward, batch, use_focal, deterministic=deterministic,
                                generator=generator, fused=fused, remat=remat,
                                topo_denominator=denom)
        with span("train.backward"):
            loss.backward()
            if reduce:
                stats = torch.stack([aux[k].detach() for k in ("mask_loss", "topo_loss",
                                                                "loss")])
                dist.all_reduce(stats)
                aux = dict(zip(("mask_loss", "topo_loss", "loss"), stats / world))
        with span("train.grad_norm"):
            for p in params:
                if p.grad is None and p.requires_grad:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in params if p.grad is not None]
            grad_norm = torch.nn.utils.get_total_norm(grads)
            if clip_norm > 0.0:
                scale = (clip_norm / grad_norm.clamp(min=1e-12)).clamp(max=1.0)
                for g in grads:
                    g.mul_(scale)
        with span("train.finite_sync", wait, "wait_seconds"):
            finite = bool(torch.isfinite(aux["loss"]) & torch.isfinite(grad_norm))
        with span("train.update"):
            if finite:
                apply_update(optimizer, boundary)
        with span("train.aux_sync", wait, "wait_seconds"):
            out = {k: v.item() for k, v in aux.items()}
            out.update(grad_norm=grad_norm.item(), skipped=0.0 if finite else 1.0)
        with span("train.release"):  # the loss's graph and the batch, freed here
            del loss, aux, batch
        out.update(wait)
        return out

    return train_step


def make_eval_step(config, model):
    """eval_step(batch) -> losses and metric counts as tensors. An optional
    batch["sample_weight"] [B] weights every sum, so the padding samples of
    a ragged last batch (weight 0) count nowhere. Under a process group
    the topology loss is this rank's share of the global batch's (one
    all-reduce of its valid count and weight), so the ranks' summed totals
    give one process's validation metrics."""
    use_focal = bool(config.FOCAL_LOSS)
    device = next(model.parameters()).device
    mask_loss_el = sigmoid_focal_loss if use_focal else bce_with_logits

    @torch.no_grad()
    def eval_step(batch) -> dict:
        b = materialize_batch(batch, device)
        w = b.get("sample_weight")
        w = torch.ones(b["rgb"].shape[0], device=device) if w is None else w.float()
        w_pix = w[:, None, None]
        mask_logits, mask_scores, topo_logits, topo_scores = model(
            b["rgb"], b["graph_points"], b["pairs"], b["valid"], deterministic=True)
        kp, road = b["keypoint_mask"], b["road_mask"]
        mask_el = mask_loss_el(mask_logits, torch.stack([kp, road], dim=3), reduction="none")
        per_sample = float(np.prod(mask_el.shape[1:]))
        mask_loss = (mask_el * w_pix[..., None]).sum() / (w.sum() * per_sample).clamp(min=1.0)
        topo_valid = b["valid"] & (w > 0)[:, None, None]
        topo_loss = masked_topo_loss(topo_logits, b["connected"], topo_valid)
        if distributed():
            # this rank's share of the global batch's topology mean, scaled
            # so that _accumulate_eval's topo_loss * weight, summed over the
            # ranks, is that mean times the global weight
            counts = torch.stack([topo_valid.sum(dtype=torch.float32), w.sum()])
            dist.all_reduce(counts)
            share = masked_topo_loss(topo_logits, b["connected"], topo_valid,
                                     counts[0].clamp(min=1.0)) * counts[1]
            topo_loss = torch.where(w.sum() > 0, share / w.sum(), torch.zeros_like(share))
        valid_i = topo_valid.int()
        topo_gt = (1 - valid_i) * -1 + valid_i * b["connected"].int()
        return {
            "mask_loss": mask_loss,
            "topo_loss": topo_loss,
            "loss": mask_loss + topo_loss,
            "weight": w.sum(),
            "kp_iou": torch.stack(binary_iou_counts(mask_scores[..., 0], kp, weights=w_pix)),
            "road_iou": torch.stack(binary_iou_counts(mask_scores[..., 1], road, weights=w_pix)),
            "topo_f1": torch.stack(binary_f1_counts(topo_scores[..., 0], topo_gt)),
            "kp_pr": torch.stack(pr_histogram(mask_scores[..., 0], (kp >= 0.5).int(),
                                              weights=w_pix)),
            "road_pr": torch.stack(pr_histogram(mask_scores[..., 1], (road >= 0.5).int(),
                                                weights=w_pix)),
            "topo_pr": torch.stack(pr_histogram(topo_scores[..., 0], topo_gt)),
        }

    return eval_step


def _accumulate_eval(total, out):
    """Fold one eval step into the totals: losses weighted by the batch's
    sample weight, counts added."""
    out = {k: v.cpu().numpy().astype(np.float64) for k, v in out.items()}
    for key in ("loss", "mask_loss", "topo_loss"):
        out[key] = out[key] * out["weight"]
    if total is None:
        return out
    return {k: total[k] + out[k] for k in total}


def _sum_across_ranks(total, device) -> dict:
    """Every rank's totals summed (JAX's process_allgather and sum over
    hosts), as float64 on `device` (NCCL reduces only on the card)."""
    keys = sorted(total)
    flat = torch.cat([torch.as_tensor(total[k], dtype=torch.float64).reshape(-1)
                      for k in keys]).to(device)
    dist.all_reduce(flat)
    flat = flat.cpu().numpy()
    out, at = {}, 0
    for k in keys:
        shape = np.shape(total[k])
        size = int(np.prod(shape))
        out[k] = flat[at:at + size].reshape(shape)
        at += size
    return out


def _finish_eval_metrics(total, device=None) -> dict:
    """Totals -> metrics; under a process group (`device` the rank's) the
    totals are summed across ranks first."""
    if device is not None and distributed():
        total = _sum_across_ranks(total, device)
    w = max(float(total["weight"]), 1.0)
    tp, fp, fn = total["topo_f1"]
    return {
        "val_loss": float(total["loss"]) / w,
        "val_mask_loss": float(total["mask_loss"]) / w,
        "val_topo_loss": float(total["topo_loss"]) / w,
        "keypoint_iou": float(total["kp_iou"][0] / max(total["kp_iou"][1], 1)),
        "road_iou": float(total["road_iou"][0] / max(total["road_iou"][1], 1)),
        "val_samples": w,
        "topo_f1": float(2 * tp / max(2 * tp + fp + fn, 1)),
        "_pr_histograms": {"keypoint": total["kp_pr"], "road": total["road_pr"],
                           "topo": total["topo_pr"]},
    }


def _evaluate(eval_step, loader) -> dict:
    total = None
    for batch in loader:
        total = _accumulate_eval(total, eval_step(batch))
    return {} if total is None else _finish_eval_metrics(total)


def run_validation(config, model, loader) -> dict:
    """Validation / calibration pass without an optimizer (the test CLI's
    path): metrics and the PR histograms for find_best_threshold."""
    return _evaluate(make_eval_step(config, model), loader)


class Trainer:
    """Epoch loop, validation, checkpoints and logging for one model on one
    device, and under an initialised process group for this rank of a
    data-parallel run (the module docstring). Dropout draws from a
    torch.Generator on that device seeded with the rank (0 alone);
    `deterministic` turns dropout off (the parity checks). `logger`
    (utils/logging.py::MetricsLogger or None) receives, on rank 0, the
    train_* aux of every logged step and the paths of the validation
    panels. `history` holds the aux of every step taken (the JAX trainer
    keeps only the logged ones)."""

    def __init__(self, config, model, output_dir: str, steps_per_epoch: int,
                 device="cuda", log_every: int = 50, logger=None, deterministic: bool = False):
        self.config = config
        self.output_dir = output_dir
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.log_every = log_every
        self.logger = logger
        self.rank = dist.get_rank() if distributed() else 0
        self.forward_model = None
        if distributed():
            # the SAM decoder's iou head is computed and dropped: it gets no
            # gradient, which DDP accepts only when told to look for it
            self.forward_model = DistributedDataParallel(
                self.model, device_ids=[self.device] if self.device.type == "cuda" else None,
                find_unused_parameters=bool(self.model.use_sam_decoder))
        self.optimizer = build_optimizer(config, self.model)
        self._train_step = make_train_step(config, self.model, self.optimizer, steps_per_epoch,
                                           self.forward_model, deterministic)
        self._eval_step = make_eval_step(config, self.model)
        self.generator = torch.Generator(device=self.device).manual_seed(self.rank)
        self.step = 0  # train steps taken, skipped ones included
        self.history: list = []

    def train_epoch(self, loader, epoch: int) -> list:
        """One pass over `loader`; returns the aux of every log_every-th
        step. Each aux has "seconds", the host time since the previous step
        returned (the first: since the loop began), "data_seconds", the
        part of it spent in the loader's next (the train.data span), and the
        step's "wait_seconds" (make_train_step). Every step ends in a host
        sync, so from the second step on "seconds" is the step's wall
        time."""
        logs = []
        t_prev = time.perf_counter()
        batches = iter(loader)
        for i in itertools.count():
            with span("train.data") as data:
                batch = next(batches, _END)
            if batch is _END:
                break
            aux = self._train_step(batch, self.generator)
            now = time.perf_counter()
            aux.update(seconds=now - t_prev, data_seconds=data.seconds, epoch=epoch, batch=i)
            t_prev = now
            self.step += 1
            self.history.append(aux)
            if i % self.log_every == 0:
                logs.append(aux)
                if self.rank:
                    continue
                if self.logger is not None:
                    self.logger.log({f"train_{k}": v for k, v in aux.items()}, step=self.step)
                print(f"epoch {epoch} step {i}/{len(loader)} loss {aux['loss']:.4f} mask "
                      f"{aux['mask_loss']:.4f} topo {aux['topo_loss']:.4f} grad_norm "
                      f"{aux['grad_norm']:.4f} skipped {aux['skipped']:.0f}", flush=True)
        return logs

    def validate(self, loader, epoch: int | None = None, viz_count: int = 0) -> dict:
        """Streaming validation metrics over `loader`; with viz_count > 0
        also writes pred-vs-GT mask panels of the first batch into
        <output_dir>/val_viz."""
        total = None
        for n, batch in enumerate(loader):
            total = _accumulate_eval(total, self._eval_step(batch))
            if n == 0 and viz_count > 0 and self.rank == 0:
                self._save_val_viz(batch, epoch or 0, viz_count)
        return {} if total is None else _finish_eval_metrics(total, self.device)

    @torch.no_grad()
    def _save_val_viz(self, batch, epoch: int, count: int) -> list:
        rgb = torch.as_tensor(batch["rgb"]).to(self.device).float()
        scores, _ = self.model.infer_masks_and_features(rgb)
        paths = save_val_visualizations(os.path.join(self.output_dir, "val_viz"), epoch, batch,
                                        scores.cpu().numpy(), count=count)
        if self.logger is not None:
            self.logger.log_images("val_masks", paths, step=self.step)
        return paths

    def save_checkpoint(self, epoch: int) -> str:
        """The full train state (weights, Adam's moments and count, step)
        as one torch.save file, written by rank 0 (every rank holds the
        same state; under a process group the ranks wait for the file);
        returns its path."""
        path = os.path.join(self.output_dir, f"ckpt_epoch_{epoch}.pt")
        if self.rank == 0:
            os.makedirs(self.output_dir, exist_ok=True)
            torch.save({"model": self.model.state_dict(),
                        "optimizer": self.optimizer.state_dict(),
                        "step": self.step, "epoch": epoch}, path)
        if distributed():
            dist.barrier()
        return path

    def restore(self, path: str) -> int:
        """Load a save_checkpoint file; returns the next epoch to run."""
        payload = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        self.step = int(payload["step"])
        return int(payload["epoch"]) + 1
