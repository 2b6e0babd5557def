"""The training loss at full width against the JAX package, on the CPU:
configs/toponet_vitb_512_cityscale.yaml (ViT-B, 512 px) at COMPUTE_DTYPE
float32, the port's seed-0 weights carried into a flax tree
(models/convert.py::to_flax_params), 2 images of tools/_train.py::fake_batch,
dropout off. JAX composes its losses as sam_road_tpu/training/harness.py's
loss_fn does (its encoder on the CPU takes the einsum attention; the port's
K5 its plain version); the global gradient norm is optax.global_norm.

Tolerances: the losses within 1e-4 relative, the gradient norm within
1e-3 (the same fp32 math over ViT-B's 12 blocks, summed in another order).
sam_road_tpu_torch/tools/full_width_loss.json holds JAX's four numbers for
the card's check (chip_smoke.py); it must agree with this machine's JAX
within 1e-5 relative. Rewrite it with
    python tests/test_torch_full_width_loss.py --write
"""

import json
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from sam_road_tpu.config import load_config as jload_config
from sam_road_tpu.models.sam_road import ModelSpec
from sam_road_tpu.models.sam_road import SAMRoad as JSAMRoad
from sam_road_tpu.ops import losses as jlosses
from sam_road_tpu.training import harness as jharness
from sam_road_tpu_torch.models.convert import to_flax_params
from sam_road_tpu_torch.tools import full_width_loss as fwl

LOSS_RTOL = 1e-4
NORM_RTOL = 1e-3
FILE_RTOL = 1e-5


def jax_numbers(cfg_over: dict, tree, batch) -> dict:
    """mask_loss, topo_loss, loss and the global gradient norm through the
    JAX package's model and losses, deterministic."""
    jcfg = jload_config(fwl.CONFIG, overrides=cfg_over)
    jmodel = JSAMRoad(ModelSpec.from_config(jcfg))
    jb = jharness._materialize_batch({k: jnp.asarray(v) for k, v in batch.items()})
    use_focal = bool(jcfg.FOCAL_LOSS)

    def jloss(p):
        ml, _, tl, _ = jmodel.apply({"params": p}, jb["rgb"], jb["graph_points"], jb["pairs"],
                                    jb["valid"], deterministic=True)
        gt = jnp.stack([jb["keypoint_mask"], jb["road_mask"]], axis=3)
        mask = (jlosses.sigmoid_focal_loss if use_focal else jlosses.bce_with_logits)(ml, gt)
        topo = jlosses.masked_topo_loss(tl, jb["connected"], jb["valid"])
        return mask + topo, (mask, topo)

    (loss, (mask, topo)), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(tree)
    return {"mask_loss": float(mask), "topo_loss": float(topo), "loss": float(loss),
            "grad_norm": float(optax.global_norm(grads))}


@pytest.fixture(scope="module")
def numbers():
    """(JAX's numbers, the port's) on the same weights and batch; JAX first,
    so that the two graphs are not held at once."""
    cfg, model, batch = fwl.inputs()
    want = jax_numbers(fwl.OVERRIDES, to_flax_params(model), batch)
    got = fwl.step_numbers(cfg, model, batch, "cpu")
    return want, got


def test_full_width_loss_matches_jax(numbers):
    want, got = numbers
    for key in ("mask_loss", "topo_loss", "loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL, err_msg=key)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=NORM_RTOL)
    assert all(np.isfinite(v) and v > 0 for v in got.values())


def test_committed_jax_numbers_match_jax(numbers):
    want, _ = numbers
    stored = fwl.reference()
    assert set(stored) == set(fwl.KEYS)
    for key in fwl.KEYS:
        np.testing.assert_allclose(stored[key], want[key], rtol=FILE_RTOL, err_msg=key)


def test_port_meets_the_committed_numbers_within_the_cards_tolerance(numbers):
    """The port on the CPU meets the stored numbers within the tolerance
    the card's check uses (tools/full_width_loss.py::TOLERANCE)."""
    _, got = numbers
    assert max(fwl.relative_errors(got, fwl.reference()).values()) <= fwl.TOLERANCE


def test_main_compares_with_the_committed_numbers(monkeypatch, capsys):
    """main() runs the step once on the named device and prints its
    comparison as one JSON line; here on a tiny config, against a
    reference that is the step's own numbers."""
    tiny = dict(SAM_VERSION="vit_t", PATCH_SIZE=64, TOPO_SAMPLE_NUM=8,
                MAX_NEIGHBOR_QUERIES=4, COMPUTE_DTYPE="float32")
    monkeypatch.setattr(fwl, "OVERRIDES", tiny)
    cfg, model, batch = fwl.inputs()
    own = fwl.step_numbers(cfg, model, batch, "cpu")
    monkeypatch.setattr(fwl, "reference", lambda: own)
    result = fwl.main("cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        json.loads(json.dumps(result))
    assert result["ok"] and max(result["rel_err"].values()) == 0.0
    assert result["launches"] == {} and result["seconds"] > 0



def test_main_tf32_control_restores_the_flags(monkeypatch, capsys):
    """main(tf32=True), the control, reports that TF32 was on and leaves
    cuBLAS's and cuDNN's TF32 flags as it found them."""
    import torch

    tiny = dict(SAM_VERSION="vit_t", PATCH_SIZE=64, TOPO_SAMPLE_NUM=8,
                MAX_NEIGHBOR_QUERIES=4, COMPUTE_DTYPE="float32")
    monkeypatch.setattr(fwl, "OVERRIDES", tiny)
    cfg, model, batch = fwl.inputs()
    own = fwl.step_numbers(cfg, model, batch, "cpu")
    monkeypatch.setattr(fwl, "reference", lambda: own)
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    result = fwl.main("cpu", tf32=True)
    assert result["tf32"] and result["ok"]  # the CPU's products ignore the flags
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == was
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["tf32"]


if __name__ == "__main__" and "--write" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    _, model, batch = fwl.inputs()
    numbers = jax_numbers(fwl.OVERRIDES, to_flax_params(model), batch)
    with open(fwl.REFERENCE, "w") as f:
        json.dump(numbers, f, indent=1)
        f.write("\n")
    print(json.dumps(numbers))
