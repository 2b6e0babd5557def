"""The port's training CLI (python -m sam_road_tpu_torch.cli.train) on the
CPU over the spacenet fixture (tests/synthetic_data.py) at vit_t, 80 px,
fp32, FUSED_ENCODER_TRAIN on: the files it writes, --resume, the device
check, and that no module of the port imports what the GPU machine lacks.
"""

import ast
import glob
import json
import os

import cv2
import numpy as np
import pytest
import torch

from sam_road_tpu.utils.viz import render_val_mask_panel as jrender_val_mask_panel
from sam_road_tpu_torch.cli import train
from sam_road_tpu_torch.config import load_config, read_flat_yaml, write_flat_yaml
from sam_road_tpu_torch.data.dataset import BatchLoader, SatMapDataset
from sam_road_tpu_torch.data.png import read_png
from sam_road_tpu_torch.training.harness import applied_updates
from synthetic_data import make_spacenet_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "sam_road_tpu", "cv2", "PIL", "yaml",
             "networkx"}


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("spacenet"))
    make_spacenet_fixture(root, image_size=160, spacing=40)
    return root


def _config(tmp_path, **over):
    cfg = read_flat_yaml(os.path.join(REPO, "configs", "toponet_vitb_256_spacenet.yaml"))
    cfg.update(IMAGE_SIZE=160, SAM_VERSION="vit_t", PATCH_SIZE=80, COMPUTE_DTYPE="float32",
               TOPO_SAMPLE_NUM=8, MAX_NEIGHBOR_QUERIES=4, NEIGHBOR_RADIUS=48, BATCH_SIZE=2,
               FUSED_ENCODER_TRAIN=True, DATA_WORKER_NUM=2, TRAIN_EPOCHS=1, VAL_VIZ_COUNT=4,
               SAM_CKPT_PATH=str(tmp_path / "no_such_sam.pth"))
    cfg.update(over)
    path = str(tmp_path / f"cfg{len(os.listdir(tmp_path))}.yaml")
    write_flat_yaml(path, cfg)
    return path


def _run(cfg_path, data_root, out, *extra):
    return train.main(["--config", cfg_path, "--device", "cpu", "--data_root", data_root,
                       "--output_dir", str(out), *extra])


def test_fast_dev_run_writes_config_checkpoint_and_panels(tmp_path, data_root, capsys):
    cfg_path = _config(tmp_path)
    out = tmp_path / "run"
    trainer = _run(cfg_path, data_root, out, "--fast_dev_run")
    assert "training from random init" in capsys.readouterr().out
    cfg = load_config(cfg_path)
    assert read_flat_yaml(str(out / "config.yaml")) == cfg.to_dict()
    assert os.path.exists(out / "ckpt_epoch_0.pt")
    assert not os.path.exists(out / "metrics.jsonl")  # dev runs log nothing, as in JAX
    assert [h["epoch"] for h in trainer.history] == [0, 0]  # 2 steps
    assert all(np.isfinite(h["loss"]) and h["skipped"] == 0 for h in trainer.history)

    # the panels of the first validation batch, against the JAX renderer on
    # the same batch and the trained model's mask scores
    batch = next(iter(BatchLoader(SatMapDataset(cfg, is_train=False, dev_run=True,
                                                data_root=data_root), 2)))
    with torch.no_grad():
        scores = trainer.model.infer_masks_and_features(torch.from_numpy(batch["rgb"]).float())[0]
    scores = scores.numpy()
    panels = sorted(glob.glob(str(out / "val_viz" / "*.png")))
    assert [os.path.basename(p) for p in panels] == ["val_epoch0_sample0.png",
                                                      "val_epoch0_sample1.png"]
    for i, path in enumerate(panels):
        want = jrender_val_mask_panel(batch["rgb"][i].astype(np.float32),
                                      batch["keypoint_mask"][i] / 255.0,
                                      batch["road_mask"][i] / 255.0, scores[i, ..., 0],
                                      scores[i, ..., 1])
        got = read_png(path)
        assert got.tobytes() == want.tobytes()
        np.testing.assert_array_equal(cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB), want)


def test_resume_continues_at_the_next_epoch(tmp_path, data_root):
    """An epoch, then --resume from its checkpoint with TRAIN_EPOCHS 2: only
    epoch 1 runs, Adam's count and the step count carry on, and both runs
    log JSON lines."""
    first = _run(_config(tmp_path), data_root, tmp_path / "a", "--steps_per_epoch", "2")
    assert applied_updates(first.optimizer) == 2
    second = _run(_config(tmp_path, TRAIN_EPOCHS=2), data_root, tmp_path / "b",
                  "--steps_per_epoch", "2", "--resume", str(tmp_path / "a" / "ckpt_epoch_0.pt"))
    assert [h["epoch"] for h in second.history] == [1, 1]
    assert applied_updates(second.optimizer) == 4 and second.step == 4
    assert sorted(os.listdir(tmp_path / "b")) == ["ckpt_epoch_1.pt", "config.yaml",
                                                   "metrics.jsonl", "val_viz"]
    for run, epoch in (("a", 0), ("b", 1)):
        with open(tmp_path / run / "metrics.jsonl") as f:
            records = [json.loads(line) for line in f]
        assert records[0]["train_epoch"] == epoch and "train_loss" in records[0]
        assert records[-1]["epoch"] == epoch and np.isfinite(records[-1]["val_loss"])
        assert any("val_masks" in r for r in records)


def test_device_cuda_raises_without_a_gpu_and_sam_checkpoint_is_not_skipped(tmp_path,
                                                                           data_root):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda is valid here")
    cfg_path = _config(tmp_path)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--config", cfg_path, "--output_dir", str(tmp_path / "x")])
    assert not os.path.exists(tmp_path / "x")
    sam = tmp_path / "sam.pth"
    sam.write_bytes(b"")  # an existing file is loaded, so an empty one fails
    with pytest.raises(EOFError):
        _run(cfg_path, data_root, tmp_path / "y", "--sam_ckpt", str(sam))


def test_fast_dev_run_starts_from_a_sam_checkpoint(tmp_path, data_root, capsys):
    """A SAM-format .pth at 1024 px geometry (vit_t widths): the encoder
    loads through the pos-embed resize, the decoders stay at random init,
    and two steps of Adam at BASE_LR 1e-4 x ENCODER_LR_FACTOR move each
    loaded weight by far less than its distance from the random init."""
    from test_torch_infer_cli import _fake_sam_state_dict

    sd = _fake_sam_state_dict(5)
    sam = tmp_path / "sam_fake.pth"
    torch.save(sd, str(sam))
    trainer = _run(_config(tmp_path, BASE_LR=1e-4), data_root, tmp_path / "run",
                   "--fast_dev_run", "--sam_ckpt", str(sam))
    out = capsys.readouterr().out
    assert "###### Matched params ######" in out and "training from random init" not in out
    state = trainer.model.state_dict()
    n_encoder = sum(1 for k in state if k.startswith("image_encoder"))
    assert f"... {n_encoder} total" in out
    assert "map_decoder.0.weight" in out.split("###### Mismatched params ######")[1]
    assert len(trainer.history) == 2 and all(h["skipped"] == 0 for h in trainer.history)
    qkv = state["image_encoder.blocks.0.attn.qkv.weight"].cpu()
    assert (qkv - sd["image_encoder.blocks.0.attn.qkv.weight"]).abs().max() < 1e-3
    assert state["image_encoder.pos_embed"].shape == (1, 5, 5, 64)  # 64x64 resized to 80 px


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_the_gpu_machine_lacks():
    """Every module of sam_road_tpu_torch and chip_smoke.py: no jax, no JAX
    package, no cv2, PIL, PyYAML or networkx, at any depth of the file."""
    paths = glob.glob(os.path.join(REPO, "sam_road_tpu_torch", "**", "*.py"), recursive=True)
    paths.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(paths) > 30
    found = {(os.path.relpath(p, REPO), m) for p in paths for m in _imported_modules(p)
             if m.split(".")[0] in FORBIDDEN}
    assert not found


def test_maybe_trace_and_metrics_logger(tmp_path):
    """maybe_trace writes a Chrome trace only when given a directory; the
    logger appends JSON lines, and writes nothing when disabled."""
    from sam_road_tpu_torch.utils.logging import MetricsLogger
    from sam_road_tpu_torch.utils.profiling import maybe_trace

    with maybe_trace(""):
        torch.ones(4).sum()
    with maybe_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    (trace,) = glob.glob(str(tmp_path / "trace" / "trace_*.json"))
    with open(trace) as f:
        assert "traceEvents" in json.load(f)
    MetricsLogger(str(tmp_path / "off"), disabled=True).log({"a": 1})
    assert not os.path.exists(tmp_path / "off" / "metrics.jsonl")
    logger = MetricsLogger(str(tmp_path / "on"))
    logger.log({"a": 1}, step=3)
    logger.log_images("val_masks", ["x.png"], step=4)
    with open(tmp_path / "on" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [(r.get("a"), r.get("val_masks"), r["step"]) for r in records] == [
        (1, None, 3), (None, ["x.png"], 4)]
