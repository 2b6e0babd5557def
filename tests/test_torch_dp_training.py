"""The port's data-parallel training (training/harness.py under
DistributedDataParallel) on the CPU: two gloo processes
(tests/torch_dp_worker.py), each with its half of every global batch,
against one process on the full batches, and against the JAX Trainer on a
2-device mesh of tests/conftest.py's CPU devices.

The cases run the step deterministic (no dropout draws), at vit_t / 64 px /
fp32, BASE_LR 1e-4. Tolerances:
  two ranks vs one process   atol 1e-6 on the losses, grad_norm, every
                             gradient DDP averaged, every parameter after
                             the step, and the validation metrics (the same
                             fp32 math; DDP sums the two halves' gradients
                             where one process sums the batch). Adam's
                             first update moves a weight by lr * g / (|g| +
                             1e-8): where g is fp32 summation noise around
                             an exact zero (the key biases of every
                             attention: softmax ignores a shift common to
                             all keys), that is up to lr either way in any
                             two runs. Weights whose gradient is below
                             NOISE in both runs are held to that bound, lr,
                             instead.
  two ranks vs JAX           tests/test_torch_training.py's TOL, atol = rtol
                             = 1e-4
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from sam_road_tpu.config import load_config as jload_config
from sam_road_tpu.models.sam_road import init_params
from sam_road_tpu.parallel.mesh import make_mesh as jmake_mesh
from sam_road_tpu.training import harness as jharness
from sam_road_tpu_torch.config import load_config
from sam_road_tpu_torch.data.dataset import collate_batch
from sam_road_tpu_torch.models.convert import from_flax_params, load_flax_params
from sam_road_tpu_torch.models.sam_road import SAMRoad
from sam_road_tpu_torch.ops.losses import masked_topo_loss
from sam_road_tpu_torch.training.harness import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")
ATOL = 1e-6
NOISE = 1e-7  # |gradient| below which Adam's first update is noise / eps
TOL = dict(atol=1e-4, rtol=1e-4)
BASE = dict(SAM_VERSION="vit_t", PATCH_SIZE=64, COMPUTE_DTYPE="float32", TOPO_SAMPLE_NUM=8,
            MAX_NEIGHBOR_QUERIES=4, BATCH_SIZE=4, BASE_LR=1e-4)
CONFIGS = {"unequal": BASE, "nonfinite": BASE,
           "jax": dict(BASE, TOPONET_VERSION="no_transformer")}  # JAX's step has no dropout


def _batch(seed, valid_p=(0.15, 0.15, 0.9, 0.9), S=8, K=4, patch=64):
    """collate_batch of 4 samples; sample i's pairs are valid with
    probability valid_p[i], so the two halves hold different counts."""
    r = np.random.default_rng(seed)
    samples = []
    for p in valid_p:
        n = int(r.integers(10, 40))
        valid = r.random((S, K)) < p
        valid[0, 0] = True
        samples.append({
            "rgb": r.integers(0, 256, (patch, patch, 3)).astype(np.float32),
            "keypoint_mask": (r.random((patch, patch)) < 0.1).astype(np.float32),
            "road_mask": (r.random((patch, patch)) < 0.3).astype(np.float32),
            "graph_points": r.uniform(0, patch, (n, 2)).astype(np.float32),
            "pairs": r.integers(0, n, (S, K, 2)).astype(np.int32),
            "connected": (r.random((S, K)) < 0.4) & valid,
            "valid": valid,
        })
    return collate_batch(samples, point_bucket=16)


def _tree(config, seed):
    r = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jax.jit(lambda: init_params(jload_config(overrides=config)))())
    return jax.tree.map(lambda p: p + 0.02 * r.normal(size=p.shape).astype(p.dtype), tree)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The cases' inputs, both ranks' results, and one process's."""
    work = str(tmp_path_factory.mktemp("ddp"))
    good = _batch(60)
    bad = dict(good, rgb=good["rgb"].astype(np.float32))
    bad["rgb"][3, 0, 0, 0] = np.nan  # rank 1's half only
    ragged = _batch(62, valid_p=(0.5,) * 4)
    ragged["sample_weight"] = np.array([1, 1, 1, 0], np.float32)
    evals = [_batch(61, valid_p=(0.5,) * 4), ragged]
    trees = {name: _tree(cfg, 70) for name, cfg in CONFIGS.items()}
    cases = {}
    for name, cfg in CONFIGS.items():
        model = load_flax_params(SAMRoad.from_config(load_config(overrides=cfg)), trees[name])
        train = {"unequal": [good], "nonfinite": [bad, good], "jax": [good]}[name]
        cases[name] = dict(config=cfg, state=model.state_dict(), train=train, eval=evals)
    torch.save({"cases": cases}, os.path.join(work, "setup.pt"))
    # two threads a rank, as torchrun's default of one: the ranks share the
    # machine with each other and with the other test workers
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), "2", str(port), work], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{text[-4000:]}"
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    single = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the ranks' count: the same kernels, the same sums a row
    try:
        for name, case in cases.items():
            cfg = load_config(overrides=case["config"])
            model = SAMRoad.from_config(cfg)
            model.load_state_dict(case["state"])
            trainer = Trainer(cfg, model, work, steps_per_epoch=10, device="cpu", log_every=1,
                              deterministic=True)
            metrics = trainer.validate(case["eval"])
            logs = trainer.train_epoch(case["train"], epoch=0)
            single[name] = dict(logs=logs, metrics=metrics,
                                params=dict(model.named_parameters()),
                                grads={n: p.grad for n, p in model.named_parameters()})
    finally:
        torch.set_num_threads(threads)
    return dict(cases=cases, trees=trees, ranks=ranks, single=single, work=work)


def _same_step(got, want, atol=ATOL):
    for key in ("loss", "mask_loss", "topo_loss", "grad_norm", "skipped"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol, err_msg=key)


def _same_params(got, want, **tol):
    for name, p in want.items():
        np.testing.assert_allclose(got[name].numpy(), p.detach().numpy(),
                                   **(tol or dict(rtol=0, atol=ATOL)), err_msg=name)


def _same_step_state(rank, single):
    """DDP's averaged gradients equal one process's; so do the weights
    after Adam's step, where the gradient is above noise (the docstring)."""
    lr = BASE["BASE_LR"]
    for name, p in single["params"].items():
        g_got, g_want = rank["grads"][name].numpy(), single["grads"][name].numpy()
        np.testing.assert_allclose(g_got, g_want, rtol=0, atol=ATOL, err_msg=name)
        noise = (np.abs(g_got) < NOISE) & (np.abs(g_want) < NOISE)
        gap = np.abs(rank["params"][name].numpy() - p.detach().numpy())
        assert gap[~noise].max(initial=0.0) <= ATOL, name
        assert gap[noise].max(initial=0.0) <= lr, name


def test_ddp_step_with_unequal_valid_counts_matches_the_full_batch(runs):
    """Halves with 6 and 27 valid pairs (of 64): the step's losses,
    grad_norm and parameters equal the full batch's. Where each rank divided
    its topology loss by its own count, the average would be off by far
    more than the tolerance."""
    batch = runs["cases"]["unequal"]["train"][0]
    counts = batch["valid"].reshape(2, -1).sum(axis=1)
    assert counts[0] * 2 < counts[1]
    single = runs["single"]["unequal"]
    for rank in runs["ranks"]:
        _same_step(rank["unequal"]["logs"][0], single["logs"][0])
        _same_step_state(rank["unequal"], single)
    # what averaging the ranks' own masked means would have reported
    logits = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 8, 4, 1)))
    conn, valid = (torch.from_numpy(batch[k]) for k in ("connected", "valid"))
    halves = [masked_topo_loss(logits[i:i + 2], conn[i:i + 2], valid[i:i + 2]) for i in (0, 2)]
    assert abs(float(sum(halves)) / 2 - float(masked_topo_loss(logits, conn, valid))) > 1e-3


def test_nonfinite_half_makes_both_ranks_skip(runs):
    """A NaN in rank 1's rows only: both ranks report the step skipped and
    keep their parameters; the next good step equals one process's."""
    single = runs["single"]["nonfinite"]
    assert single["logs"][0]["skipped"] == 1.0
    for rank in runs["ranks"]:
        logs = rank["nonfinite"]["logs"]
        assert logs[0]["skipped"] == 1.0 and not np.isfinite(logs[0]["loss"])
        _same_step(logs[1], single["logs"][1])
        _same_step_state(rank["nonfinite"], single)


def test_validation_totals_are_summed_across_ranks(runs):
    """Each rank validates its half of every eval batch (the ragged one's
    weight-0 row included) with the initial weights; the summed totals give
    one process's metrics on both ranks."""
    want = runs["single"]["unequal"]["metrics"]
    assert want["val_samples"] == 7.0
    for rank in runs["ranks"]:
        got = rank["unequal"]["metrics"]
        assert got["val_samples"] == 7.0
        for key in ("val_loss", "val_mask_loss", "val_topo_loss", "keypoint_iou", "road_iou",
                    "topo_f1"):
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=ATOL, err_msg=key)
        for key, hist in want["_pr_histograms"].items():
            np.testing.assert_array_equal(got["_pr_histograms"][key], hist)


def test_ddp_step_matches_the_jax_trainer_on_a_two_device_mesh(runs, tmp_path):
    """TOPONET_VERSION no_transformer (the JAX step draws dropout in
    TopoNet's layers): one step of the two ranks against the JAX Trainer
    over a 2-device dp mesh on the same global batch."""
    cfg = CONFIGS["jax"]
    trainer = jharness.Trainer(config=jload_config(overrides=cfg), params=runs["trees"]["jax"],
                               output_dir=str(tmp_path), steps_per_epoch=10, log_every=1,
                               mesh=jmake_mesh(2, jax.devices()[:2]))
    want = trainer.train_epoch(runs["cases"]["jax"]["train"], epoch=0)[0]
    want_params = from_flax_params(jax.tree.map(np.asarray, trainer.state.params))
    for rank in runs["ranks"]:
        got = rank["jax"]["logs"][0]
        for key in ("loss", "mask_loss", "topo_loss", "grad_norm"):
            np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)
        assert got["skipped"] == want["skipped"] == 0.0
        _same_params(rank["jax"]["params"], want_params, **TOL)


@pytest.mark.parametrize("keys,match", [(dict(DP_SHARDS=4), "DP_SHARDS=4 but the run has 2"),
                                        (dict(BATCH_SIZE=3), "must divide across 2 ranks")])
def test_train_cli_checks_the_world_before_joining(tmp_path, monkeypatch, keys, match):
    """Under torchrun's environment (2 ranks) the training CLI refuses a
    DP_SHARDS other than 0 or the world size, and a BATCH_SIZE that does
    not divide; both before it joins the process group."""
    from sam_road_tpu_torch.cli import train
    from sam_road_tpu_torch.config import write_flat_yaml

    cfg = str(tmp_path / "cfg.yaml")
    write_flat_yaml(cfg, load_config(overrides={**BASE, **keys}).to_dict())
    for name, value in dict(WORLD_SIZE="2", RANK="0", LOCAL_RANK="0").items():
        monkeypatch.setenv(name, value)
    with pytest.raises(ValueError, match=match):
        train.main(["--config", cfg, "--device", "cpu", "--output_dir", str(tmp_path / "o")])
