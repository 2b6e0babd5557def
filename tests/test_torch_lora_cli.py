"""The port's CLIs with LoRA and the SAM decoder (USE_SAM_DECODER,
ENCODER_LORA, LORA_RANK 2, FUSED_ENCODER off: the eager encoder) at vit_t
on the CPU, over tests/synthetic_data.py's spacenet fixture.

- cli.infer and cli.test against the JAX CLIs from one Lightning-format
  .ckpt (an init_params tree, perturbed so that LoRA's B is nonzero):
  masks within 1 uint8 level, the same graph pickles, the same threshold
  JSON, as tests/test_torch_infer_cli.py holds the default model.
- cli.train --dev_run from a SAM-format .pth with the decoder's keys: the
  SAM decoder loads, the adapters and TopoNet start from the init, the
  base encoder stays the checkpoint's, the adapters train.
"""

import json
import os

import numpy as np
import pytest
import torch

from sam_road_tpu.cli import infer as jinfer
from sam_road_tpu.cli import test as jtest
from sam_road_tpu.config import load_config as jload_config
from sam_road_tpu.models import sam_road as jsam_road
from sam_road_tpu_torch.cli import infer, test, train
from sam_road_tpu_torch.config import read_flat_yaml, write_flat_yaml
from sam_road_tpu_torch.models.convert import from_flax_params
from synthetic_data import make_spacenet_fixture
from test_torch_engine import _load_jax_native
from test_torch_infer_cli import ENGINE, REPO, _read_outputs, _traced_init
from test_torch_sam_decoder import _sam_pth_with_decoder
from test_torch_training import _perturb

LORA = dict(ENGINE, USE_SAM_DECODER=True, ENCODER_LORA=True, LORA_RANK=2, FUSED_ENCODER=False)


@pytest.fixture(scope="module", autouse=True)
def traced_jax_init():
    """The JAX CLIs call init_params eagerly (~15 s on the CPU): they get
    the traced one."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsam_road, "init_params", _traced_init)
        yield


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("lora_cli")
    data = str(root / "data")
    make_spacenet_fixture(data, image_size=160, spacing=40)
    values = read_flat_yaml(os.path.join(REPO, "configs", "toponet_vitb_256_spacenet.yaml"))
    values.update(LORA)
    cfg = str(root / "cfg.yaml")
    write_flat_yaml(cfg, values)
    params = _perturb(_traced_init(jload_config(cfg)), 80)
    ckpt = str(root / "samroad_lora.ckpt")
    torch.save({"state_dict": from_flax_params(params), "epoch": 3}, ckpt)
    with open(os.path.join(data, "spacenet", "data_split.json")) as f:
        test_ids = json.load(f)["test"]
    return dict(data=data, cfg=cfg, ckpt=ckpt, values=values, test_ids=test_ids)


def test_lora_infer_cli_matches_jax_cli(fixture, tmp_path, monkeypatch):
    _load_jax_native()
    monkeypatch.chdir(tmp_path)
    args = ["--config", fixture["cfg"], "--checkpoint", fixture["ckpt"], "--data_root",
            fixture["data"]]
    jinfer.main(args + ["--output_dir", "j"])
    out = infer.main(args + ["--output_dir", "t", "--device", "cpu"])
    got_masks, got_graphs = _read_outputs(out, fixture["test_ids"])
    want_masks, want_graphs = _read_outputs("./save/j", fixture["test_ids"])
    for k, want in want_masks.items():
        assert got_masks[k].shape == want.shape == (160, 160)
        assert np.abs(got_masks[k].astype(int) - want.astype(int)).max() <= 1, k
    assert got_graphs == want_graphs
    assert sorted(os.listdir(out)) == sorted(os.listdir("./save/j"))


def test_lora_test_cli_matches_jax_cli(fixture, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = ["--config", fixture["cfg"], "--checkpoint", fixture["ckpt"], "--dev_run",
            "--data_root", fixture["data"]]
    jtest.main(args + ["--output_json", "j.json"])
    got = test.main(args + ["--output_json", "t.json", "--device", "cpu"])
    with open("j.json") as f:
        want = json.load(f)
    with open("t.json") as f:
        assert json.load(f) == want == json.loads(json.dumps(got))
    assert set(want) == {"keypoint", "road", "topo"}


def test_lora_train_cli_dev_run_from_a_sam_checkpoint(fixture, tmp_path, capsys):
    sd = _sam_pth_with_decoder(81)
    sam = str(tmp_path / "sam_decoder.pth")
    torch.save(sd, sam)
    values = dict(fixture["values"], IMAGE_SIZE=160, PATCH_SIZE=80, BATCH_SIZE=2,
                  TOPO_SAMPLE_NUM=8, NEIGHBOR_RADIUS=48, DATA_WORKER_NUM=2, TRAIN_EPOCHS=1)
    cfg = str(tmp_path / "cfg.yaml")
    write_flat_yaml(cfg, values)
    trainer = train.main(["--config", cfg, "--dev_run", "--steps_per_epoch", "2", "--device",
                          "cpu", "--data_root", fixture["data"], "--output_dir",
                          str(tmp_path / "run"), "--sam_ckpt", sam])
    out = capsys.readouterr().out
    mismatched = out.split("###### Mismatched params ######")[1].split()
    state = trainer.model.state_dict()
    lora = {k for k in state if ".linear_" in k}
    assert lora and lora <= set(mismatched)
    assert not [n for n in mismatched if n.startswith(("prompt_encoder.", "mask_decoder."))]
    assert os.path.exists(tmp_path / "run" / "ckpt_epoch_0.pt")
    assert len(trainer.history) == 2
    assert all(np.isfinite(h["loss"]) and h["skipped"] == 0 for h in trainer.history)
    # the frozen base encoder is the checkpoint's (the blocks' weights need
    # no resize); the adapters' B, zero at the start, trained
    for key in ("blocks.0.attn.qkv.weight", "blocks.1.mlp.lin2.bias", "neck.2.weight"):
        assert torch.equal(state[f"image_encoder.{key}"].cpu(), sd[f"image_encoder.{key}"])
    assert state["image_encoder.blocks.0.attn.qkv.linear_b_v.weight"].abs().max() > 0
    key = "mask_decoder.iou_prediction_head.layers.0.weight"  # the loss does not reach it
    assert torch.equal(state[key].cpu(), sd[key])
    assert not torch.equal(state["mask_decoder.iou_token.weight"].cpu(),
                           sd["mask_decoder.iou_token.weight"])
