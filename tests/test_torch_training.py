"""The port's training slice (sam_road_tpu_torch: K5 in the encoder, the
training forward, losses, metrics, collate_batch and training/harness.py)
against the JAX package on the CPU, at vit_t and fp32.

Inputs and weights come from numpy seeds and go to both sides (weights
through the bridge, models/convert.py). Where the JAX side reaches a Pallas
kernel it runs in interpret mode (use_flash="always"). Tolerances, each
for the same math in fp32 summed in another order:
  activations, losses    atol = rtol = 1e-4 (as tests/test_torch_models.py)
  gradients              atol = 1e-4 * (largest |gradient| of the leaf) + 1e-7,
                         rtol = 1e-3 (a sum over the batch, 2 encoder blocks,
                         the decoder and 3 TopoNet layers)
  Adam updates           atol = 1e-6 (updates are near the 1e-3 and 1e-4
                         rates; the two divide by sqrt(v) + eps in
                         another order)
  metric counts          exact on identical scores; from the two models'
                         scores, a mask pixel within fp32 noise of a
                         threshold may land on the other side: at most 0.1 %
                         of the counts move (and 1e-3 on IoU and F1, their
                         ratios)
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sam_road_tpu.config import load_config as jload_config
from sam_road_tpu.data.dataset import collate_batch as jcollate_batch
from sam_road_tpu.models.sam_road import ModelSpec
from sam_road_tpu.models.sam_road import SAMRoad as JSAMRoad
from sam_road_tpu.models.sam_road import init_params
from sam_road_tpu.models.vit import ENCODER_SPECS
from sam_road_tpu.models.vit import ImageEncoderViT as JImageEncoderViT
from sam_road_tpu.ops import losses as jlosses
from sam_road_tpu.ops import metrics as jmetrics
from sam_road_tpu.training import harness as jharness
from sam_road_tpu_torch.config import load_config
from sam_road_tpu_torch.data.dataset import collate_batch
from sam_road_tpu_torch.models.convert import from_flax_params, load_flax_params
from sam_road_tpu_torch.models.sam_road import SAMRoad
from sam_road_tpu_torch.models.toponet import TransformerEncoderLayer, dropout
from sam_road_tpu_torch.models.vit import ImageEncoderViT
from sam_road_tpu_torch.ops import attention, metrics
from sam_road_tpu_torch.training import harness

TOL = dict(atol=1e-4, rtol=1e-4)
# 192 px: 12 x 12 tokens, so the windows pad to 14 x 14 = 196 tokens and the
# global block has 144: every attention runs through K5 (H * W >= 128)
TRAIN = dict(SAM_VERSION="vit_t", PATCH_SIZE=192, COMPUTE_DTYPE="float32", TOPO_SAMPLE_NUM=8,
             MAX_NEIGHBOR_QUERIES=4, BATCH_SIZE=2, BASE_LR=1e-3)
# 64 px for the harness's own checks: small and fast
TINY = dict(TRAIN, PATCH_SIZE=64)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _perturb(tree, seed):
    r = np.random.default_rng(seed)
    return jax.tree.map(lambda p: p + 0.02 * r.normal(size=p.shape).astype(p.dtype),
                        _np_tree(tree))


@pytest.fixture(scope="module")
def params():
    """Perturbed init_params at vit_t / 192 px (the rel-pos tables nonzero)."""
    cfg = jload_config(overrides=TRAIN)
    return _perturb(jax.jit(lambda: init_params(cfg))(), 40)


@pytest.fixture(scope="module")
def tiny_params():
    cfg = jload_config(overrides=TINY)
    return _perturb(jax.jit(lambda: init_params(cfg))(), 41)


def _samples(seed, B=2, patch=192, S=8, K=4):
    """Samples in SatMapDataset's format: float rgb 0-255, masks v / 255,
    ragged graph_points, pairs within range, at least one valid pair."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        n = int(r.integers(10, 40))
        valid = r.random((S, K)) < 0.6
        valid[0, 0] = True
        out.append({
            "rgb": r.integers(0, 256, (patch, patch, 3)).astype(np.float32),
            "keypoint_mask": (r.random((patch, patch)) < 0.1).astype(np.float32),
            "road_mask": (r.random((patch, patch)) < 0.3).astype(np.float32),
            "graph_points": r.uniform(0, patch, (n, 2)).astype(np.float32),
            "pairs": r.integers(0, n, (S, K, 2)).astype(np.int32),
            "connected": (r.random((S, K)) < 0.4) & valid,
            "valid": valid,
        })
    return out


def _batch(seed, B=2, patch=192):
    return collate_batch(_samples(seed, B, patch), point_bucket=16)


def _model(cfg_over, tree):
    return load_flax_params(SAMRoad.from_config(load_config(overrides=cfg_over)), tree)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


@pytest.fixture
def count_k5(monkeypatch):
    """Counts the calls of K5's plain version (what K5 runs on CPU)."""
    calls = []
    plain = attention.fused_attention_plain
    monkeypatch.setattr(attention, "fused_attention_plain",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    return calls


def test_flash_encoder_matches_flax_always(count_k5):
    """use_flash: both blocks (windows of 196 tokens, 144 global) fold the
    rel-pos into q and k and run K5, against the flax encoder with the
    Pallas kernel in interpret mode."""
    spec = ENCODER_SPECS["vit_t"]
    kw = dict(img_size=192, embed_dim=spec["embed_dim"], depth=spec["depth"],
              num_heads=spec["num_heads"], global_attn_indexes=spec["global_attn_indexes"])
    jenc = JImageEncoderViT(**kw, use_flash="always", dtype=jnp.float32)
    x = np.random.default_rng(42).normal(size=(2, 192, 192, 3)).astype(np.float32)
    tree = _perturb(jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 43)
    want = jax.jit(jenc.apply)({"params": tree}, jnp.asarray(x))
    tenc = load_flax_params(ImageEncoderViT(**kw, use_flash=True), tree, scope="image_encoder")
    with torch.no_grad():
        got = tenc(torch.from_numpy(x))
    _close(got, want)
    assert [tuple(s) for s in count_k5] == [(2, 2, 196, 60), (2, 2, 144, 56)]


@pytest.mark.parametrize("focal,fused", [pytest.param(False, False, id="False"),
                                         pytest.param(True, False, id="True"),
                                         pytest.param(False, True, id="fused")])
def test_loss_and_gradients_match_jax(params, count_k5, focal, fused):
    """SAMRoad.forward + the losses, deterministic, against
    jax.value_and_grad of the same composition; every gradient mapped to
    torch layout through from_flax_params. `fused`: the port's
    FUSED_ENCODER_TRAIN forward (the K6 wrappers, no K5) against the same
    flax gradients."""
    over = dict(TRAIN, FOCAL_LOSS=focal)
    jspec = dataclasses.replace(ModelSpec.from_config(jload_config(overrides=over)),
                                flash_attention="always")
    jmodel = JSAMRoad(jspec)
    batch = _batch(44)
    jb = jharness._materialize_batch({k: jnp.asarray(v) for k, v in batch.items()})

    def jloss(p):
        ml, _, tl, _ = jmodel.apply({"params": p}, jb["rgb"], jb["graph_points"], jb["pairs"],
                                    jb["valid"], deterministic=True)
        gt = jnp.stack([jb["keypoint_mask"], jb["road_mask"]], axis=3)
        mask = (jlosses.sigmoid_focal_loss if focal else jlosses.bce_with_logits)(ml, gt)
        return mask + jlosses.masked_topo_loss(tl, jb["connected"], jb["valid"])

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params)
    model = _model(over, params)
    loss, aux = harness.loss_fn(model, harness.materialize_batch(batch, "cpu"), focal,
                                deterministic=True, fused=fused)
    loss.backward()
    _close(loss.item(), want_loss)
    assert len(count_k5) == (0 if fused else 2)  # eager: both encoder blocks through K5
    want = from_flax_params(_np_tree(want_grads))
    grads = dict(model.named_parameters())
    assert set(want) == set(grads)
    for name, w in want.items():
        scale = float(w.abs().max())
        _close(grads[name].grad, w, atol=1e-4 * scale + 1e-7, rtol=1e-3,
               err_msg=name)


def _grad_tree(tree, seed):
    r = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (0.01 * r.normal(size=p.shape)).astype(np.float32), tree)


def _adam_both(tree, over, steps_per_epoch, n_steps):
    """The same gradients into optax (the JAX build_optimizer) and into the
    port's Adam; yields (step, optax updates, port updates) in torch
    layout."""
    jtx = jharness.build_optimizer(jload_config(overrides=over), tree, steps_per_epoch)
    jstate = jtx.init(tree)
    model = _model(over, tree)
    opt = harness.build_optimizer(load_config(overrides=over), model)
    params = dict(model.named_parameters())
    for step in range(n_steps):
        g = _grad_tree(tree, 100 + step)
        updates, jstate = jtx.update(g, jstate, tree)
        before = {n: p.detach().clone() for n, p in params.items()}
        for name, grad in from_flax_params(g).items():
            params[name].grad = grad
        harness.apply_update(opt, 9 * steps_per_epoch)
        got = {n: params[n].detach() - before[n] for n in params}
        yield step, from_flax_params(_np_tree(updates)), got


@pytest.mark.parametrize("freeze", [False, True])
def test_adam_group_updates_match_optax(tiny_params, freeze):
    """Encoder at BASE_LR x ENCODER_LR_FACTOR (or frozen: zero updates),
    decoder and TopoNet at BASE_LR, over two steps (the moments carry)."""
    over = dict(TINY, FREEZE_ENCODER=freeze)
    for _, want, got in _adam_both(tiny_params, over, 100, 2):
        for name in want:
            _close(got[name], want[name], atol=1e-6, rtol=0, err_msg=name)
        enc = got["image_encoder.blocks.0.attn.qkv.weight"].abs().max()
        dec = got["map_decoder.0.weight"].abs().max()
        assert (enc == 0) if freeze else (0.5e-4 < enc < 2e-4)
        assert 0.5e-3 < dec < 2e-3


def test_lr_drops_tenfold_at_nine_epochs_like_optax(tiny_params):
    """The x0.1 step at 9 * steps_per_epoch applied updates, held against
    optax.piecewise_constant_schedule on the steps either side of it."""
    seen = {}
    for step, want, got in _adam_both(tiny_params, TINY, 1, 10):
        if step in (8, 9):
            for name in want:
                _close(got[name], want[name], atol=1e-6, rtol=0, err_msg=name)
            seen[step] = got["map_decoder.0.weight"].abs().max().item()
    assert 0.5e-3 < seen[8] < 2e-3 and 0.5e-4 < seen[9] < 2e-4


def _trainer(tree, tmp_path, **over):
    cfg = load_config(overrides=dict(TINY, **over))
    return harness.Trainer(cfg, _model(TINY, tree), str(tmp_path), steps_per_epoch=10,
                           device="cpu", log_every=1)


def test_frozen_encoder_unchanged_and_counted_in_grad_norm(tiny_params, tmp_path):
    trainer = _trainer(tiny_params, tmp_path, FREEZE_ENCODER=True)
    params = dict(trainer.model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    logs = trainer.train_epoch([_batch(45, patch=64)] * 2, epoch=0)
    encoder = [n for n in params if n.startswith("image_encoder.")]
    for name in encoder:
        assert params[name].requires_grad
        torch.testing.assert_close(params[name].detach(), before[name], rtol=0, atol=0)
    assert (params["map_decoder.0.weight"] - before["map_decoder.0.weight"]).abs().max() > 0
    # the last step's gradients are still held: the encoder's count in grad_norm
    norm_all = torch.nn.utils.get_total_norm([p.grad for p in params.values()])
    norm_rest = torch.nn.utils.get_total_norm([params[n].grad for n in params
                                               if n not in encoder])
    assert logs[-1]["grad_norm"] == pytest.approx(norm_all.item(), rel=1e-6)
    assert norm_all > norm_rest * (1 + 1e-4)


def test_nonfinite_batch_is_skipped(tiny_params, tmp_path):
    """A NaN batch changes neither the parameters nor Adam's state (its step
    count stays); the next good batch trains."""
    trainer = _trainer(tiny_params, tmp_path)
    good = _batch(46, patch=64)
    trainer.train_epoch([good], epoch=0)
    params = [p.detach().clone() for p in trainer.model.parameters()]
    state = {k: {n: t.clone() for n, t in v.items()}
             for k, v in trainer.optimizer.state_dict()["state"].items()}
    bad = dict(good, rgb=np.full(good["rgb"].shape, np.nan, np.float32))
    logs = trainer.train_epoch([bad], epoch=0)
    assert logs[0]["skipped"] == 1.0 and not np.isfinite(logs[0]["loss"])
    for a, b in zip(params, trainer.model.parameters()):
        torch.testing.assert_close(b.detach(), a, rtol=0, atol=0)
    after = trainer.optimizer.state_dict()["state"]
    for k, v in state.items():
        for n, t in v.items():
            torch.testing.assert_close(after[k][n], t, rtol=0, atol=0)
    assert harness.applied_updates(trainer.optimizer) == 1
    logs = trainer.train_epoch([good], epoch=0)
    assert logs[0]["skipped"] == 0.0 and np.isfinite(logs[0]["loss"])
    assert harness.applied_updates(trainer.optimizer) == 2 and trainer.step == 3


def test_grad_clip_bounds_update(tiny_params, tmp_path):
    trainer = _trainer(tiny_params, tmp_path, GRAD_CLIP_NORM=1e-8)
    params = list(trainer.model.parameters())
    before = [p.detach().clone() for p in params]
    logs = trainer.train_epoch([_batch(47, patch=64)], epoch=0)
    assert logs[0]["grad_norm"] > 1e-3  # reported before clipping
    clipped = torch.nn.utils.get_total_norm([p.grad for p in params])
    assert clipped.item() == pytest.approx(1e-8, rel=1e-4)
    delta = max((p.detach() - b).abs().max().item() for p, b in zip(params, before))
    assert 0 < delta <= 2 * float(TINY["BASE_LR"])


@pytest.fixture(scope="module")
def eval_pair(params):
    """The JAX and the port's eval step on one batch of 3 whose last sample
    is padding (sample_weight 0)."""
    batch = _batch(48, B=3)
    batch["sample_weight"] = np.array([1.0, 1.0, 0.0], np.float32)
    jcfg = jload_config(overrides=TRAIN)
    want = _np_tree(jharness.make_eval_step(jcfg)(params, {k: jnp.asarray(v)
                                                           for k, v in batch.items()}))
    got = harness.make_eval_step(load_config(overrides=TRAIN), _model(TRAIN, params))(batch)
    return batch, want, {k: v.numpy() for k, v in got.items()}


def test_eval_step_matches_jax(eval_pair):
    _, want, got = eval_pair
    assert set(got) == set(want)
    for key in ("mask_loss", "topo_loss", "loss", "weight"):
        _close(got[key], want[key])
    for key in ("kp_iou", "road_iou", "topo_f1", "kp_pr", "road_pr", "topo_pr"):
        moved = np.abs(got[key] - want[key]).sum()
        assert moved <= 1e-3 * max(np.abs(want[key]).sum(), 1.0), key


def test_eval_sample_weight_drops_padding_samples(eval_pair, params):
    """The weight-0 sample counts nowhere: the same batch without it gives
    the same sums."""
    batch, _, got = eval_pair
    real = {k: v[:2] for k, v in batch.items() if k != "sample_weight"}
    plain = harness.make_eval_step(load_config(overrides=TRAIN), _model(TRAIN, params))(real)
    for key in ("kp_iou", "road_iou", "topo_f1", "kp_pr", "road_pr", "topo_pr", "weight"):
        np.testing.assert_array_equal(plain[key].numpy(), got[key], err_msg=key)
    for key in ("mask_loss", "topo_loss"):
        _close(plain[key].numpy(), got[key], atol=1e-6, rtol=1e-6)


def test_run_validation_matches_jax(tiny_params):
    """Two batches streamed through run_validation: losses weighted by
    each batch's samples, counts summed, as the JAX run_validation."""
    batches = [_batch(53, patch=64), _batch(54, B=3, patch=64)]
    want = jharness.run_validation(jload_config(overrides=TINY), tiny_params, batches)
    got = harness.run_validation(load_config(overrides=TINY), _model(TINY, tiny_params), batches)
    assert set(got) == set(want) and got["val_samples"] == 5.0
    for key in ("val_loss", "val_mask_loss", "val_topo_loss", "keypoint_iou", "road_iou",
                "topo_f1"):
        _close(got[key], want[key], atol=1e-3, rtol=1e-3)
    for key, hist in want["_pr_histograms"].items():
        moved = np.abs(got["_pr_histograms"][key] - hist).sum()
        assert moved <= 1e-3 * hist.sum(), key


def test_metrics_match_jax_on_identical_scores():
    """Counts, weighted histograms and the best-F1 threshold exactly equal
    the JAX functions' on the same scores."""
    r = np.random.default_rng(49)
    scores = r.random((3, 32, 32)).astype(np.float32)
    targets = (r.random((3, 32, 32)) < 0.3).astype(np.float32)
    w = np.array([1.0, 0.0, 1.0], np.float32)[:, None, None]
    topo = r.random((3, 8, 4)).astype(np.float32)
    topo_gt = r.integers(-1, 2, (3, 8, 4)).astype(np.int32)
    j, t = jnp.asarray, torch.from_numpy
    pairs = [
        (jmetrics.binary_iou_counts(j(scores), j(targets), weights=j(w)),
         metrics.binary_iou_counts(t(scores), t(targets), weights=t(w))),
        (jmetrics.binary_f1_counts(j(topo), j(topo_gt)),
         metrics.binary_f1_counts(t(topo), t(topo_gt))),
        (jmetrics.pr_histogram(j(scores), j((targets >= 0.5).astype(np.int32)), weights=j(w)),
         metrics.pr_histogram(t(scores), t((targets >= 0.5).astype(np.int32)), weights=t(w))),
        (jmetrics.pr_histogram(j(topo), j(topo_gt)), metrics.pr_histogram(t(topo), t(topo_gt))),
    ]
    for want, got in pairs:
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    pos, neg = (h.numpy() for h in metrics.pr_histogram(t(topo), t(topo_gt)))
    assert metrics.find_best_threshold(pos, neg) == jmetrics.find_best_threshold(pos, neg)
    for a, b in zip(metrics.pr_curve_from_histograms(pos, neg),
                    jmetrics.pr_curve_from_histograms(pos, neg)):
        np.testing.assert_array_equal(a, b)


def test_collate_batch_is_byte_equal_and_materializes_exactly():
    samples = _samples(50, B=3, patch=32)
    got, want = collate_batch(samples), jcollate_batch(samples)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        assert got[key].tobytes() == want[key].tobytes(), key
    assert got["graph_points"].shape[1] == 128
    dev = harness.materialize_batch(got, "cpu")
    jdev = jharness._materialize_batch({k: jnp.asarray(v) for k, v in got.items()})
    for key in ("rgb", "keypoint_mask", "road_mask"):
        assert dev[key].dtype == torch.float32
        np.testing.assert_array_equal(dev[key].numpy(), np.asarray(jdev[key]))
    np.testing.assert_array_equal(dev["rgb"].numpy(), np.stack([s["rgb"] for s in samples]))


def test_checkpoint_round_trips(tiny_params, tmp_path):
    """Weights, Adam's moments and count, and the step survive
    save_checkpoint / restore; both trainers then take the same next
    step."""
    a = _trainer(tiny_params, tmp_path)
    batch = _batch(51, patch=64)
    a.train_epoch([batch, batch], epoch=0)
    path = a.save_checkpoint(epoch=0)
    b = _trainer(_perturb(tiny_params, 52), tmp_path)
    assert b.restore(path) == 1 and b.step == a.step == 2
    for (n, p), q in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        torch.testing.assert_close(q, p, rtol=0, atol=0, msg=n)
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for k in sa["state"]:
        for n in sa["state"][k]:
            torch.testing.assert_close(sb["state"][k][n], sa["state"][k][n], rtol=0, atol=0)
    a.generator.manual_seed(7)
    b.generator.manual_seed(7)
    la, lb = a.train_epoch([batch], 1), b.train_epoch([batch], 1)
    assert la[0]["loss"] == lb[0]["loss"]
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=0)


def test_dropout_is_seeded_and_off_when_deterministic():
    x = torch.ones(64, 128)
    kept = dropout(x, 0.1, False, torch.Generator().manual_seed(0))
    assert torch.unique(kept).tolist() == [0.0, pytest.approx(1 / 0.9)]
    assert 0.05 < (kept == 0).float().mean().item() < 0.15
    torch.testing.assert_close(dropout(x, 0.1, False, torch.Generator().manual_seed(0)), kept,
                               rtol=0, atol=0)
    assert not torch.equal(dropout(x, 0.1, False, torch.Generator().manual_seed(1)), kept)
    assert dropout(x, 0.1, True) is x
    layer = TransformerEncoderLayer(16, 4, 16)
    h = torch.randn(3, 5, 16, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        off = layer(h)
        on = [layer(h, deterministic=False, generator=torch.Generator().manual_seed(3))
              for _ in range(2)]
    torch.testing.assert_close(on[0], on[1], rtol=0, atol=0)
    assert not torch.allclose(on[0], off)
