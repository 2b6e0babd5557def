"""Training harness (counterpart of sam_road_tpu/training/harness.py):
Adam per parameter group, the train step with gradient clipping and the
non-finite guard, the eval step with streaming metrics, and checkpoints.

  encoder             BASE_LR * ENCODER_LR_FACTOR, or frozen (FREEZE_ENCODER)
  decoder, toponet    BASE_LR
  schedule            x0.1 once 9 * steps_per_epoch updates were applied
                      (MultiStepLR at epoch 9; optax's piecewise constant
                      schedule over Adam's own count)

A frozen encoder keeps requires_grad and stays out of the optimizer: its
gradients are computed and count in grad_norm and in clipping, as the JAX
package's optax.set_to_zero group does. Parameters stay fp32 (the model
casts to the compute dtype at use), so gradients and Adam's moments are
fp32. Not ported yet: the K6 path (FUSED_ENCODER_TRAIN), LoRA, the
validation panels and the metrics logger.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from sam_road_tpu_torch.ops.losses import bce_with_logits, masked_topo_loss, sigmoid_focal_loss
from sam_road_tpu_torch.ops.metrics import binary_f1_counts, binary_iou_counts, pr_histogram


def param_group(name: str) -> str:
    """Optimizer group of a parameter, by its top-level module."""
    top = name.split(".", 1)[0]
    if top == "image_encoder":
        return "encoder"
    if top == "topo_net":
        return "toponet"
    return "decoder"


def build_optimizer(config, model) -> torch.optim.Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8, as optax.adam) with one group per
    trained module group; each group keeps its unscheduled rate in
    "initial_lr" (apply_update schedules it)."""
    if config.ENCODER_LORA:
        raise NotImplementedError("ENCODER_LORA is not ported yet")
    base_lr = float(config.BASE_LR)
    lrs = {"encoder": base_lr * float(config.ENCODER_LR_FACTOR), "decoder": base_lr,
           "toponet": base_lr}
    groups: dict = {}
    for name, p in model.named_parameters():
        group = param_group(name)
        if group == "encoder" and config.FREEZE_ENCODER:
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


def loss_fn(model, batch, use_focal: bool, deterministic: bool = False, generator=None):
    """Mask loss (BCE or focal) + masked topology BCE on a materialized
    batch. Returns (loss, {"mask_loss", "topo_loss", "loss"}), fp32."""
    mask_logits, _, topo_logits, _ = model(batch["rgb"], batch["graph_points"],
                                           batch["pairs"], batch["valid"],
                                           deterministic=deterministic, generator=generator)
    gt = torch.stack([batch["keypoint_mask"], batch["road_mask"]], dim=3)
    mask_loss = (sigmoid_focal_loss if use_focal else bce_with_logits)(mask_logits, gt)
    topo_loss = masked_topo_loss(topo_logits, batch["connected"], batch["valid"])
    loss = mask_loss + topo_loss
    return loss, {"mask_loss": mask_loss, "topo_loss": topo_loss, "loss": loss}


def make_train_step(config, model, optimizer, steps_per_epoch: int):
    """train_step(batch, generator) -> aux: forward with dropout, loss,
    gradients, grad_norm over all of them, GRAD_CLIP_NORM scaling (off at
    0), and the Adam update. A step whose loss or grad_norm is not finite
    changes neither the parameters nor Adam's state (aux["skipped"] = 1);
    checking costs one host sync per step."""
    if config.FUSED_ENCODER_TRAIN:
        raise NotImplementedError("FUSED_ENCODER_TRAIN (the K6 path) is not ported yet")
    use_focal = bool(config.FOCAL_LOSS)
    clip_norm = float(config.GRAD_CLIP_NORM or 0.0)
    boundary = 9 * int(steps_per_epoch)
    params = list(model.parameters())
    device = params[0].device

    def train_step(batch, generator) -> dict:
        model.zero_grad(set_to_none=True)
        loss, aux = loss_fn(model, materialize_batch(batch, device), use_focal,
                            deterministic=False, generator=generator)
        loss.backward()
        grads = [p.grad for p in params if p.grad is not None]
        grad_norm = torch.nn.utils.get_total_norm(grads)
        if clip_norm > 0.0:
            scale = (clip_norm / grad_norm.clamp(min=1e-12)).clamp(max=1.0)
            for g in grads:
                g.mul_(scale)
        finite = bool(torch.isfinite(loss) & torch.isfinite(grad_norm))
        if finite:
            apply_update(optimizer, boundary)
        out = {k: v.item() for k, v in aux.items()}
        out.update(grad_norm=grad_norm.item(), skipped=0.0 if finite else 1.0)
        return out

    return train_step


def make_eval_step(config, model):
    """eval_step(batch) -> losses and metric counts as tensors. An optional
    batch["sample_weight"] [B] weights every sum, so the padding samples of
    a ragged last batch (weight 0) count nowhere."""
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


def _finish_eval_metrics(total) -> dict:
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
    """Epoch loop and checkpoints for one model on one device. Dropout
    draws from a torch.Generator on that device seeded with 0."""

    def __init__(self, config, model, output_dir: str, steps_per_epoch: int,
                 device="cuda", log_every: int = 50):
        self.config = config
        self.output_dir = output_dir
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.log_every = log_every
        self.optimizer = build_optimizer(config, self.model)
        self._train_step = make_train_step(config, self.model, self.optimizer, steps_per_epoch)
        self._eval_step = make_eval_step(config, self.model)
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        self.step = 0  # train steps taken, skipped ones included

    def train_epoch(self, loader, epoch: int) -> list:
        """One pass over `loader`; returns the aux of every log_every-th
        step, each with "seconds": host time since the previous step
        returned (the first: since the loop began). Every step ends in a
        host sync, so from the second step on this is the step's wall
        time."""
        logs = []
        t_prev = time.perf_counter()
        for i, batch in enumerate(loader):
            aux = self._train_step(batch, self.generator)
            now = time.perf_counter()
            aux["seconds"], t_prev = now - t_prev, now
            self.step += 1
            if i % self.log_every == 0:
                aux.update(epoch=epoch, batch=i)
                logs.append(aux)
                print(f"epoch {epoch} step {i} loss {aux['loss']:.4f} mask "
                      f"{aux['mask_loss']:.4f} topo {aux['topo_loss']:.4f} grad_norm "
                      f"{aux['grad_norm']:.4f} skipped {aux['skipped']:.0f}", flush=True)
        return logs

    def validate(self, loader) -> dict:
        return _evaluate(self._eval_step, loader)

    def save_checkpoint(self, epoch: int) -> str:
        """The full train state (weights, Adam's moments and count, step)
        as one torch.save file; returns its path."""
        os.makedirs(self.output_dir, exist_ok=True)
        path = os.path.join(self.output_dir, f"ckpt_epoch_{epoch}.pt")
        torch.save({"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                    "step": self.step, "epoch": epoch}, path)
        return path

    def restore(self, path: str) -> int:
        """Load a save_checkpoint file; returns the next epoch to run."""
        payload = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        self.step = int(payload["step"])
        return int(payload["epoch"]) + 1
