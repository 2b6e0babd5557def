"""SAM-Road's training step in plain PyTorch, written from the published
training (github.com/htcr/sam_road, model.py::training_step and
configure_optimizers): BCE with logits on the keypoint and road masks
(mean), BCE on the pair logits masked by the valid pairs and divided by
their count, the sum of the two; Adam (0.9, 0.999, eps 1e-8) with the
encoder at BASE_LR * ENCODER_LR_FACTOR and the rest at BASE_LR; gradients
unclipped (GRAD_CLIP_NORM 0). TopoNet's dropout masks come from a
torch.Generator seeded as the trainer's is (seed 0 on the run's device),
drawn in the same order, so the reference drops the same activations.
Nothing here imports the program.
"""

from __future__ import annotations

import torch

from benchmark.reference import model


def bce(logits, target):
    return (logits.clamp(min=0) - logits * target + torch.log1p(torch.exp(-logits.abs())))


def loss(sd, arch, batch, prec=model.FP32, gen=None):
    """(loss, mask loss, topo loss) of a batch of tensors on the device."""
    mask_logits, topo_logits = model.forward(sd, arch, batch["rgb"], batch["graph_points"],
                                             batch["pairs"], batch["valid"], prec, gen)
    gt = torch.stack([batch["keypoint_mask"], batch["road_mask"]], dim=3)
    mask_loss = bce(mask_logits, gt).mean()
    valid = batch["valid"].float()
    topo = bce(topo_logits, batch["connected"].float()) * valid
    topo_loss = topo.sum() / valid.sum().clamp(min=1.0)
    return mask_loss + topo_loss, mask_loss, topo_loss


def to_device(batch: dict, device) -> dict:
    """collate_batch's uint8 encoding back to floats: rgb 0-255, masks 0-1."""
    out = {}
    for key, val in batch.items():
        t = torch.as_tensor(val).to(device)
        if key == "rgb":
            t = t.float()
        elif key in ("keypoint_mask", "road_mask"):
            t = t.float() / 255.0
        out[key] = t
    return out


def lr_of(name: str, cfg: dict) -> float:
    base = float(cfg["BASE_LR"])
    return base * float(cfg["ENCODER_LR_FACTOR"]) if name.startswith("image_encoder.") else base


def steps(sd, arch, cfg: dict, batches, device, prec=model.FP32, half_batch: bool = False):
    """len(batches) steps from the state dict sd. Returns per step (loss,
    mask loss, topo loss), the first step's gradient by leaf, its total
    norm, and the parameters after the last step, by leaf. half_batch
    leaves out the second half of every batch (a planted fault)."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in sd.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    gen = torch.Generator(device=device).manual_seed(0)
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, first_grad, first_norm = [], None, None
    for t, raw in enumerate(batches, start=1):
        batch = to_device(raw, device)
        if half_batch:
            batch = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        total, mask_loss, topo_loss = loss(params, arch, batch, prec, gen)
        grads = torch.autograd.grad(total, list(params.values()))
        losses.append(tuple(float(x.detach()) for x in (total, mask_loss, topo_loss)))
        grads = dict(zip(params, grads))
        if t == 1:
            first_grad = {k: g.detach().clone() for k, g in grads.items()}
            first_norm = float(torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads.values()])))
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mhat = m[k] / (1 - b1 ** t)
                vhat = v2[k] / (1 - b2 ** t)
                p.sub_(lr_of(k, cfg) * mhat / (vhat.sqrt() + eps))
        del grads, total
    return losses, first_grad, first_norm, {k: p.detach() for k, p in params.items()}
