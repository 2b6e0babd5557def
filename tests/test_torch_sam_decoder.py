"""The port's SAM mask decoder (models/sam_decoder.py) and LoRA adapters
(models/vit.py::LoRAQKV), through the model, the weight loading, the
training harness and the engine, against the JAX package on the CPU at
vit_t in fp32.

Inputs come from numpy seeds and go to both sides; weights go through the
bridge (models/convert.py), perturbed so that LoRA's B, every bias and
every norm are generic. Where the JAX encoder reaches K5 it runs the
Pallas kernel in interpret mode (flash_attention="always"). Tolerances,
as tests/test_torch_training.py states them: activations and losses
atol = rtol = 1e-4; gradients atol = 1e-4 * (largest |gradient| of the
leaf) + 1e-7, rtol = 1e-3; Adam updates atol = 1e-6; engine masks within 1
uint8 level and the graph within test_engine_matches_jax_engine's bounds.
"""

import dataclasses
from functools import partial

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from sam_road_tpu.config import load_config as jload_config
from sam_road_tpu.inference.engine import TiledInferenceEngine as JEngine
from sam_road_tpu.models import convert as jconvert
from sam_road_tpu.models import sam_road as jsam_road
from sam_road_tpu.models.sam_decoder import SamMaskDecoderHead as JHead
from sam_road_tpu.models.sam_road import ModelSpec
from sam_road_tpu.models.sam_road import SAMRoad as JSAMRoad
from sam_road_tpu.models.sam_road import init_params
from sam_road_tpu.ops import losses as jlosses
from sam_road_tpu.training import harness as jharness
from sam_road_tpu_torch.config import load_config
from sam_road_tpu_torch.inference.engine import TiledInferenceEngine
from sam_road_tpu_torch.models import convert
from sam_road_tpu_torch.models.convert import from_flax_params, load_flax_params
from sam_road_tpu_torch.models.fast_encoder import encoder_forward_fused
from sam_road_tpu_torch.models.sam_decoder import SamMaskDecoderHead, resize_masks
from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random
from sam_road_tpu_torch.models.vit import ImageEncoderViT, LoRAQKV
from sam_road_tpu_torch.training import harness
from test_torch_engine import ENGINE, _edge_set, _load_jax_native
from test_torch_infer_cli import _assert_same_load, _fake_sam_state_dict
from test_torch_training import TOL, _batch, _close, _grad_tree, _np_tree, _perturb
from test_torch_training import count_k5  # noqa: F401  (a fixture)

LORA = dict(USE_SAM_DECODER=True, ENCODER_LORA=True, LORA_RANK=2)
# 192 px: every encoder attention runs through K5 (windows of 196, 144 global)
TRAIN = dict(SAM_VERSION="vit_t", PATCH_SIZE=192, COMPUTE_DTYPE="float32", TOPO_SAMPLE_NUM=8,
             MAX_NEIGHBOR_QUERIES=4, BATCH_SIZE=2, BASE_LR=1e-3, **LORA)
# 64 px: the checkpoints and the engine
SMALL = dict(SAM_VERSION="vit_t", PATCH_SIZE=64, COMPUTE_DTYPE="float32", MAX_NEIGHBOR_QUERIES=4,
             **LORA)
IOU_HEAD = "mask_decoder.iou_prediction_head."


def _traced(over):
    cfg = jload_config(overrides=over)
    return _np_tree(jax.jit(lambda: init_params(cfg))())


@pytest.fixture(scope="module")
def params():
    """Perturbed init_params at TRAIN: LoRA's B nonzero."""
    return _perturb(_traced(TRAIN), 60)


def _model(over, tree):
    return load_flax_params(SAMRoad.from_config(load_config(overrides=over)), tree)


# ---------------------------------------------------------------- the head


@pytest.mark.parametrize("h,size", [(16, 64), (6, 24), (12, 192)])
def test_resize_matches_jax_bilinear_at_the_edges(h, size):
    """resize_masks against jax.image.resize(..., "bilinear") on random
    masks: equal everywhere. The edge rows and columns (the half scale
    nearest each border, where both clamp to the first or last centre) are
    where align_corners=True, the other reading of "bilinear", parts from
    JAX."""
    r = np.random.default_rng(h)
    x = r.normal(size=(2, 2, h, h)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x.transpose(0, 2, 3, 1)), (2, size, size, 2),
                                       method="bilinear")).transpose(0, 3, 1, 2)
    got = resize_masks(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    edge = size // h // 2
    for rows in (slice(0, edge), slice(size - edge, size)):
        np.testing.assert_allclose(got[:, :, rows], want[:, :, rows], **TOL)
        np.testing.assert_allclose(got[..., rows], want[..., rows], **TOL)
    corners = F.interpolate(torch.from_numpy(x), size=(size, size), mode="bilinear",
                            align_corners=True).numpy()
    for i in (edge - 1, size - edge):
        assert np.abs(corners[:, :, i] - want[:, :, i]).max() > 1e-2
        assert np.abs(corners[..., i] - want[..., i]).max() > 1e-2


@pytest.mark.parametrize("B,h,size", [(2, 4, 64), (1, 6, 96)])
def test_head_matches_jax(B, h, size):
    """SamMaskDecoderHead against JAX's on [B, h, h, 256] embeddings, the
    weights perturbed (every bias nonzero); the masks vary at their edges."""
    r = np.random.default_rng(62 + h)
    x = r.normal(size=(B, h, h, 256)).astype(np.float32)
    jhead = JHead(image_size=size)
    tree = _perturb(jax.jit(jhead.init)(jax.random.PRNGKey(3), jnp.asarray(x))["params"], 63)
    want = np.asarray(jax.jit(jhead.apply)({"params": tree}, jnp.asarray(x)))
    head = load_flax_params(SamMaskDecoderHead(size), tree, scope="sam_decoder")
    assert all(k.startswith(("prompt_encoder.", "mask_decoder.")) for k in head.state_dict())
    assert tuple(head.state_dict()["prompt_encoder.no_mask_embed.weight"].shape) == (1, 256)
    assert isinstance(head.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix,
                      torch.nn.Parameter)
    with torch.no_grad():
        got = head(torch.from_numpy(x))
    assert got.shape == (B, size, size, 2) and got.dtype == torch.float32
    _close(got, want)
    for edge in (want[:, 0], want[:, -1], want[:, :, 0], want[:, :, -1]):  # not flat there
        assert np.abs(np.diff(edge, axis=1)).max() > 1e-3


# ---------------------------------------------------------------- LoRA


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_with_zero_b_is_bit_equal_to_the_plain_encoder(dtype):
    kw = dict(img_size=64, embed_dim=64, depth=2, num_heads=2, global_attn_indexes=(1,),
              dtype=dtype)
    torch.manual_seed(0)
    lora = ImageEncoderViT(**kw, lora_rank=2)
    plain = ImageEncoderViT(**kw)
    assert isinstance(lora.blocks[0].attn.qkv, LoRAQKV)
    base = {k: v for k, v in lora.state_dict().items() if ".linear_" not in k}
    plain.load_state_dict(base)
    assert not lora.blocks[1].attn.qkv.linear_b_v.weight.any()  # B starts at zero
    keys = {k for k in lora.state_dict() if ".linear_" in k}
    assert keys == {f"blocks.{i}.attn.qkv.linear_{ab}_{qv}.weight" for i in range(2)
                    for ab in "ab" for qv in "qv"}
    x = torch.randn(2, 64, 64, 3)
    with torch.no_grad():
        assert torch.equal(lora(x), plain(x))
        lora.blocks[0].attn.qkv.linear_b_q.weight.fill_(0.5)
        assert not torch.equal(lora(x), plain(x))


def test_fused_paths_refuse_lora_and_the_sam_decoder():
    """The engine with FUSED_ENCODER and either switch raises ValueError
    with the JAX engine's message; the fused encoder refuses a LoRA
    module (its kernels would drop the adapters)."""
    for over in (dict(USE_SAM_DECODER=True), dict(ENCODER_LORA=True, LORA_RANK=2)):
        cfg = load_config(overrides={**ENGINE, **over})
        model = SAMRoad.from_config(cfg)
        with pytest.raises(ValueError, match="FUSED_ENCODER supports the naive decoder"):
            TiledInferenceEngine(cfg, model, "cpu")
        TiledInferenceEngine(load_config(overrides={**ENGINE, **over, "FUSED_ENCODER": False}),
                             model, "cpu")
    enc = SAMRoad.from_config(load_config(overrides={**ENGINE, **LORA})).image_encoder
    with pytest.raises(ValueError, match="ENCODER_LORA"):
        encoder_forward_fused(enc, torch.zeros(1, 64, 64, 3))


def test_init_random_covers_the_new_parameters():
    model = init_random(SAMRoad.from_config(load_config(overrides=SMALL)), 0)
    state = model.state_dict()
    assert "map_decoder.0.weight" not in state and model.use_sam_decoder
    assert not state["image_encoder.blocks.0.attn.qkv.linear_b_q.weight"].any()
    assert state["image_encoder.blocks.0.attn.qkv.linear_a_q.weight"].std() > 0.05
    for key in ("mask_decoder.iou_token.weight", "mask_decoder.mask_tokens.weight",
                "prompt_encoder.no_mask_embed.weight",
                "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"):
        assert 0.5 < state[key].std() < 2.0, key
    assert torch.equal(state["mask_decoder.output_upscaling.1.weight"], torch.ones(64))
    assert not state["mask_decoder.transformer.layers.0.self_attn.q_proj.bias"].any()
    again = init_random(SAMRoad.from_config(load_config(overrides=SMALL)), 0).state_dict()
    assert all(torch.equal(v, again[k]) for k, v in state.items())


# ---------------------------------------------------------------- SAMRoad


def _jmodel(over):
    spec = dataclasses.replace(ModelSpec.from_config(jload_config(overrides=over)),
                               flash_attention="always")
    return JSAMRoad(spec)


def test_lora_samroad_inference_entry_points_match_jax(params, count_k5):
    jmodel = _jmodel(TRAIN)
    model = _model(TRAIN, params)
    r = np.random.default_rng(64)
    rgb = r.integers(0, 255, size=(2, 192, 192, 3)).astype(np.float32)
    want_masks, want_emb = jax.jit(partial(jmodel.apply,
                                           method=JSAMRoad.infer_masks_and_features))(
        {"params": params}, jnp.asarray(rgb))
    with torch.no_grad():
        masks, emb = model.infer_masks_and_features(torch.from_numpy(rgb))
    assert len(count_k5) == 2  # both encoder blocks through K5
    _close(emb, want_emb)
    _close(masks, want_masks)
    b = _batch(65)
    args = (np.asarray(want_emb), b["graph_points"], b["pairs"], b["valid"])
    want = jax.jit(partial(jmodel.apply, method=JSAMRoad.infer_toponet))(
        {"params": params}, *map(jnp.asarray, args))
    with torch.no_grad():
        got = model.infer_toponet(*map(torch.tensor, args))
    _close(got, want)


def test_lora_loss_and_gradients_match_jax(params, count_k5):
    """SAMRoad.forward + the BCE and topology losses against
    jax.value_and_grad; every gradient in torch layout. The iou head's
    output is dropped, so the loss does not reach it: JAX's gradient there
    is exactly zero and torch leaves it None (the harness fills zeros).
    The first hypernetwork MLP's mask is dropped after the product: zero
    on both sides."""
    jmodel = _jmodel(TRAIN)
    batch = _batch(66)
    jb = jharness._materialize_batch({k: jnp.asarray(v) for k, v in batch.items()})

    def jloss(p):
        ml, _, tl, _ = jmodel.apply({"params": p}, jb["rgb"], jb["graph_points"], jb["pairs"],
                                    jb["valid"], deterministic=True)
        gt = jnp.stack([jb["keypoint_mask"], jb["road_mask"]], axis=3)
        return (jlosses.bce_with_logits(ml, gt)
                + jlosses.masked_topo_loss(tl, jb["connected"], jb["valid"]))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params)
    model = _model(TRAIN, params)
    loss, _ = harness.loss_fn(model, harness.materialize_batch(batch, "cpu"), False,
                              deterministic=True)
    loss.backward()
    _close(loss.item(), want_loss)
    assert len(count_k5) == 2
    want = from_flax_params(_np_tree(want_grads))
    grads = dict(model.named_parameters())
    assert set(want) == set(grads)
    assert {n for n, p in grads.items() if p.grad is None} == {n for n in grads
                                                              if n.startswith(IOU_HEAD)}
    for name, w in want.items():
        if name.startswith(IOU_HEAD):
            assert not w.any(), name
            continue
        scale = float(w.abs().max())
        _close(grads[name].grad, w, atol=1e-4 * scale + 1e-7, rtol=1e-3, err_msg=name)


def test_adam_lora_groups_match_optax(params):
    """ENCODER_LORA: the base encoder frozen (zero updates), the adapters
    at BASE_LR, the SAM decoder and TopoNet at BASE_LR, against optax's
    multi_transform of the JAX build_optimizer (its update traced once),
    over two steps with the same gradients (the moments carry)."""
    jtx = jharness.build_optimizer(jload_config(overrides=TRAIN), params, 100)
    jstate, jupdate = jtx.init(params), jax.jit(jtx.update)
    model = _model(TRAIN, params)
    opt = harness.build_optimizer(load_config(overrides=TRAIN), model)
    assert [g["initial_lr"] for g in opt.param_groups] == [1e-3] * 3
    named = dict(model.named_parameters())
    for step in range(2):
        g = _grad_tree(params, 100 + step)
        updates, jstate = jupdate(g, jstate, params)
        before = {n: p.detach().clone() for n, p in named.items()}
        for name, grad in from_flax_params(g).items():
            named[name].grad = grad
        harness.apply_update(opt, 900)
        got = {n: named[n].detach() - before[n] for n in named}
        want = from_flax_params(_np_tree(updates))
        assert set(want) == set(got)
        for name in want:
            _close(got[name], want[name], atol=1e-6, rtol=0, err_msg=name)
        base = [n for n in got if n.startswith("image_encoder.") and ".linear_" not in n]
        assert base and all(not got[n].any() for n in base)
        for name in ("image_encoder.blocks.0.attn.qkv.linear_a_q.weight",
                     "image_encoder.blocks.1.attn.qkv.linear_b_v.weight",
                     "mask_decoder.output_upscaling.0.weight",
                     "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"):
            assert 0.5e-3 < got[name].abs().max() < 2e-3, name


def test_lora_trainer_freezes_the_base_encoder_and_counts_it_in_grad_norm(params, tmp_path):
    """Two steps through Trainer: the base encoder stays bit-unchanged and
    its gradients count in grad_norm; the adapters and the decoder move;
    every parameter holds a gradient (the iou head's zero) and Adam's count
    is the same for all of them."""
    trainer = harness.Trainer(load_config(overrides=TRAIN), _model(TRAIN, params), str(tmp_path),
                              steps_per_epoch=10, device="cpu", log_every=1)
    params = dict(trainer.model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    logs = trainer.train_epoch([_batch(67)] * 2, epoch=0)
    base = [n for n in params if n.startswith("image_encoder.") and ".linear_" not in n]
    for name in base:
        assert params[name].requires_grad
        torch.testing.assert_close(params[name].detach(), before[name], rtol=0, atol=0)
    for name in ("image_encoder.blocks.0.attn.qkv.linear_a_v.weight",
                 "image_encoder.blocks.0.attn.qkv.linear_b_q.weight",
                 "mask_decoder.transformer.layers.1.mlp.lin2.weight", "topo_net.output_proj.bias"):
        assert (params[name] - before[name]).abs().max() > 0, name
    assert all(p.grad is not None for p in params.values())
    assert all(not params[n].grad.any() for n in params if n.startswith(IOU_HEAD))
    norm_all = torch.nn.utils.get_total_norm([p.grad for p in params.values()])
    norm_rest = torch.nn.utils.get_total_norm([params[n].grad for n in params if n not in base])
    assert logs[-1]["grad_norm"] == pytest.approx(norm_all.item(), rel=1e-6)
    assert norm_all > norm_rest * (1 + 1e-4)
    steps = {int(s["step"]) for s in trainer.optimizer.state.values()}
    assert steps == {2} and harness.applied_updates(trainer.optimizer) == 2


# ---------------------------------------------------------------- checkpoints


@pytest.fixture(scope="module")
def traced_jax_init():
    """JAX's load_and_convert calls init_params eagerly (~15 s on the CPU):
    it gets the traced one."""
    cache = {}

    def traced(config):
        key = tuple(sorted((k, str(v)) for k, v in config.items()))
        if key not in cache:
            cache[key] = _np_tree(jax.jit(lambda: init_params(config))())
        return cache[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsam_road, "init_params", traced)
        yield traced


def _sam_pth_with_decoder(seed):
    """A SAM checkpoint's layout at vit_t widths: _fake_sam_state_dict's
    encoder, every mask_decoder.* and prompt_encoder.* key of SAM's
    decoder, and the prompt encoder's point and mask-input layers the null
    prompt never reads."""
    sd = _fake_sam_state_dict(seed)
    g = torch.Generator().manual_seed(seed + 1)
    head = SamMaskDecoderHead(64)
    for k, v in head.state_dict().items():
        sd[k] = torch.randn(v.shape, generator=g)
    for k, shape in (("point_embeddings.0.weight", (1, 256)), ("not_a_point_embed.weight",
                     (1, 256)), ("mask_downscaling.0.weight", (4, 1, 2, 2)),
                     ("mask_downscaling.6.bias", (256,))):
        sd[f"prompt_encoder.{k}"] = torch.randn(shape, generator=g)
    return sd


@pytest.mark.parametrize("kind", ["sam_pth", "samroad_ckpt"])
def test_checkpoints_with_decoder_and_lora_keys_load_like_jax(kind, tmp_path, traced_jax_init):
    """Through load_and_convert, the port's parameters equal JAX's merged
    tree and the matched / mismatched names are the same. A SAM .pth
    fills the SAM decoder (its point and mask-input layers skipped) and
    leaves the adapters and TopoNet; a SAMRoad .ckpt with LoRA keys fills
    everything."""
    over = SMALL
    path = str(tmp_path / "ckpt.pth")
    if kind == "sam_pth":
        torch.save(_sam_pth_with_decoder(70), path)
    else:
        tree = _perturb(traced_jax_init(jload_config(overrides=over)), 71)
        torch.save({"state_dict": from_flax_params(tree), "epoch": 9}, path)
    want_tree, want_matched, want_mismatched = jconvert.load_and_convert(
        path, jload_config(overrides=over))
    model, matched, mismatched = convert.load_and_convert(
        path, load_config(overrides=over), model=_model(over, traced_jax_init(
            jload_config(overrides=over))))
    _assert_same_load(model, want_tree, matched, mismatched, want_matched, want_mismatched)
    decoder = [n for n in model.state_dict() if n.startswith(("prompt_encoder.", "mask_decoder."))]
    assert decoder and set(decoder) <= set(matched)
    lora = {n for n in model.state_dict() if ".linear_" in n}
    if kind == "sam_pth":
        assert set(mismatched) == lora | {n for n in model.state_dict()
                                          if n.startswith("topo_net.")}
    else:
        assert not mismatched
        np.testing.assert_array_equal(
            model.image_encoder.blocks[1].attn.qkv.linear_b_v.weight.detach().numpy(),
            tree["image_encoder"]["blocks_1"]["attn"]["linear_b_v"]["kernel"].T)


# ---------------------------------------------------------------- the engine


def test_lora_engine_matches_jax_engine(traced_jax_init):
    """TiledInferenceEngine with LoRA and the SAM decoder (FUSED_ENCODER
    off) against the JAX engine, on SMALL's tree (the same parameters as
    the engine config's) perturbed."""
    _load_jax_native()
    over = {**ENGINE, **LORA, "FUSED_ENCODER": False}
    tree = _perturb(traced_jax_init(jload_config(overrides=SMALL)), 72)
    jeng = JEngine(jload_config(overrides=over), tree, point_bucket=16)
    teng = TiledInferenceEngine(load_config(overrides=over), _model(over, tree), "cpu",
                                point_bucket=16)
    img = np.random.default_rng(3).integers(0, 255, (192, 192, 3), dtype=np.uint8)
    n0, e0, kp0, road0 = jeng.infer_one_img(img)
    n1, e1, kp1, road1 = teng.infer_one_img(img)
    assert np.abs(kp0.astype(int) - kp1.astype(int)).max() <= 1
    assert np.abs(road0.astype(int) - road1.astype(int)).max() <= 1
    assert kp0.max() > kp0.min() and road0.max() > road0.min()
    # the graph, as test_engine_matches_jax_engine bounds it: a mask level
    # at a threshold may move a vertex
    assert abs(n0.shape[0] - n1.shape[0]) <= 2
    s0, s1 = _edge_set(n0, e0), _edge_set(n1, e1)
    assert len(s0) > 50 and len(s0 & s1) / len(s0 | s1) >= 0.95
