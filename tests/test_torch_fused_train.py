"""The port's K6 path (FUSED_ENCODER_TRAIN) on the CPU: the five
differentiable wrappers against the JAX package's custom_vjp functions of
the same names (Pallas in interpret mode), the differentiable fused encoder
against the port's eager encoder, REMAT_ENCODER on both encoders, and the
train step's guards.

Inputs and weights come from numpy seeds; fp32 throughout. Tolerances:
  K6 values and gradients        atol = rtol = 1e-5 (the same math summed
                                 in another order, as tests/test_torch_ops.py)
  fused vs eager encoder grads   rtol 1e-5, atol 1e-5 x the leaf's largest
                                 |gradient| (tests/test_fused_train.py's
                                 bound for the same comparison in JAX)
  remat on vs off                rtol 1e-6, atol 1e-7 (the same ops again)
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sam_road_tpu.ops import attention as jattn
from sam_road_tpu.ops import fused_block as jblock
from sam_road_tpu.ops import fused_ln as jln
from sam_road_tpu_torch.config import load_config
from sam_road_tpu_torch.models.fast_encoder import encoder_forward_fused
from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random
from sam_road_tpu_torch.ops import _build, attention, fused_block, fused_ln
from sam_road_tpu_torch.training import harness

TOL = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(SAM_VERSION="vit_t", PATCH_SIZE=64, COMPUTE_DTYPE="float32", TOPO_SAMPLE_NUM=4,
             MAX_NEIGHBOR_QUERIES=4, BATCH_SIZE=2, BASE_LR=1e-3)


def _n(r, *shape, scale=1.0):
    return (scale * r.normal(size=shape)).astype(np.float32)


def _ln_case(r, bias):
    M, C, F = 48, 64, 192
    x, s, b = _n(r, M, C), 1 + _n(r, C, scale=0.1), _n(r, C, scale=0.1)
    w = _n(r, C, F, scale=C ** -0.5)  # JAX (in, out)
    args = [x, s, b, w] + ([_n(r, F, scale=0.1)] if bias else [])
    jfn = (lambda *a: jln.ln_dense_bias_d(*a, True)) if bias else (lambda *a: jln.ln_dense_d(*a, True))
    tfn = fused_ln.ln_dense_bias_d if bias else fused_ln.ln_dense_d
    return jfn, tfn, args, {3}, (48, 192)


def _tail_case(r):
    M, C, Hd = 48, 64, 256
    args = [_n(r, M, C), _n(r, M, C), _n(r, C, C, scale=C ** -0.5), _n(r, C, scale=0.1),
            1 + _n(r, C, scale=0.1), _n(r, C, scale=0.1), _n(r, C, Hd, scale=C ** -0.5),
            _n(r, Hd, scale=0.1), _n(r, Hd, C, scale=Hd ** -0.5), _n(r, C, scale=0.1)]
    return (lambda *a: jln.proj_ln_mlp_residual_d(*a, True), fused_ln.proj_ln_mlp_residual_d,
            args, {2, 6, 8}, (M, C))


def _window_case(r):
    """A 6x6 grid padded to 8x8 at window 4, 2 heads: pad tokens are zero
    in the bias-free grid and get the bias in the kernel."""
    B, H, win, heads, C = 2, 6, 4, 2, 64
    grid = np.zeros((B, 8, 8, 3 * C), np.float32)
    grid[:, :H, :H] = _n(r, B, H, H, 3 * C)
    rows = (B, 2, 2, heads, win * win, win)
    args = [grid, _n(r, 3 * C, scale=0.5), _n(r, *rows), _n(r, *rows)]
    return (lambda *a: jblock.window_attention_rows_grid_d(*a, win, heads, True),
            lambda *a: fused_block.window_attention_rows_grid_d(*a, win, heads),
            args, set(), (B, 8, 8, C))


def _global_case(r):
    B, heads, H, W, D = 2, 2, 6, 6, 32
    N = H * W
    args = [_n(r, B, heads, N, D, scale=D ** -0.5), _n(r, B, heads, N, D), _n(r, B, heads, N, D),
            _n(r, B, heads, N, H), _n(r, B, heads, N, W)]
    return (lambda *a: jattn.attention_relpos_rows_d(*a, (H, W), True),
            lambda *a: attention.attention_relpos_rows_d(*a, (H, W)),
            args, set(), (B, heads, N, D))


CASES = {
    "ln_dense_d": lambda r: _ln_case(r, False),
    "ln_dense_bias_d": lambda r: _ln_case(r, True),
    "proj_ln_mlp_residual_d": _tail_case,
    "window_attention_rows_grid_d": _window_case,
    "attention_relpos_rows_d": _global_case,
}


@pytest.mark.parametrize("name", list(CASES))
def test_k6_wrapper_matches_jax_value_and_vjp(name):
    """Output and every input's gradient for a random cotangent against
    jax.vjp of the JAX *_d function; weights cross in torch's [out, in]
    layout (`transposed`), and the wrapper launches no kernel on CPU."""
    r = np.random.default_rng(sorted(CASES).index(name))
    jfn, tfn, args, transposed, out_shape = CASES[name](r)
    g = _n(r, *out_shape)
    want, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    leaves = [torch.tensor(a.T.copy() if i in transposed else a, requires_grad=True)
              for i, a in enumerate(args)]
    got = tfn(*leaves)
    assert type(got.grad_fn).__name__.endswith("DBackward")  # the autograd.Function
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for i, (leaf, jgrad) in enumerate(zip(leaves, vjp(jnp.asarray(g)))):
        jgrad = np.asarray(jgrad)
        np.testing.assert_allclose(leaf.grad.numpy(), jgrad.T if i in transposed else jgrad,
                                   err_msg=f"input {i}", **TOL)
    assert not _build.launches


def test_k6_backward_skips_inputs_that_need_no_gradient():
    r = np.random.default_rng(9)
    _, tfn, args, transposed, out_shape = _ln_case(r, True)
    x = torch.tensor(args[0], requires_grad=True)
    rest = [torch.from_numpy(a.T.copy() if i + 1 in transposed else a)
            for i, a in enumerate(args[1:])]
    tfn(x, *rest).backward(torch.from_numpy(_n(r, *out_shape)))
    assert x.grad is not None and all(t.grad is None for t in rest)


def _encoder_model(remat=False, seed=3):
    """vit_t at 64 px (4x4 tokens: windows pad to 14x14 and run through K5
    on the eager path), fp32, every parameter perturbed from init_random so
    the biases and rel-pos tables are generic."""
    model = init_random(SAMRoad.from_config(load_config(overrides=dict(SMALL, REMAT_ENCODER=remat))),
                        seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model


def _encoder_grads(model, fused, remat=False, seed=4):
    """Output and parameter gradients of sum(encoder(x) * R) on 2 patches."""
    r = np.random.default_rng(seed)
    x = torch.from_numpy(_n(r, 2, 64, 64, 3))
    enc = model.image_encoder
    out = encoder_forward_fused(enc, x, differentiable=True, remat=remat) if fused else enc(x)
    (out * torch.from_numpy(_n(r, *out.shape))).sum().backward()
    grads = {n: p.grad.clone() for n, p in enc.named_parameters()}
    enc.zero_grad(set_to_none=True)
    return out.detach(), grads


def test_differentiable_fused_encoder_matches_eager_encoder():
    model = _encoder_model()
    out_e, g_e = _encoder_grads(model, fused=False)
    out_f, g_f = _encoder_grads(model, fused=True)
    torch.testing.assert_close(out_f, out_e, atol=1e-5, rtol=1e-5)
    with torch.no_grad():  # the inference path: the same forward, no graph
        inf = encoder_forward_fused(model.image_encoder,
                                    torch.from_numpy(_n(np.random.default_rng(4), 2, 64, 64, 3)))
    assert not inf.requires_grad
    torch.testing.assert_close(inf, out_f, atol=0, rtol=0)
    assert set(g_f) == set(g_e)
    for name in ("blocks.0.attn.qkv.bias", "blocks.0.attn.rel_pos_h", "blocks.1.attn.rel_pos_w"):
        assert g_f[name].abs().max() > 0, name  # through the bias rows
    for name, want in g_e.items():
        scale = float(want.abs().max())
        np.testing.assert_allclose(g_f[name].numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("fused", [False, True])
def test_remat_leaves_encoder_gradients_unchanged(fused):
    """REMAT_ENCODER checkpoints every block (eager: SAMRoad.from_config;
    fused: remat=True) and recomputes it in the backward pass."""
    base, remat = _encoder_model(False), _encoder_model(True)
    assert remat.image_encoder.remat and not base.image_encoder.remat
    out_a, g_a = _encoder_grads(base, fused, remat=False)
    out_b, g_b = _encoder_grads(remat, fused, remat=True)
    torch.testing.assert_close(out_b, out_a, atol=0, rtol=0)
    for name in g_a:
        np.testing.assert_allclose(g_b[name].numpy(), g_a[name].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def test_fused_train_step_trains_and_rejects_unsupported_configs(tmp_path):
    cfg = load_config(overrides=dict(SMALL, FUSED_ENCODER_TRAIN=True))
    model = _encoder_model()
    opt = harness.build_optimizer(cfg, model)
    for over, match in ((dict(USE_SAM_DECODER=True), "decoder"),
                        (dict(ENCODER_LORA=True, LORA_RANK=2), "LORA")):
        with pytest.raises(ValueError, match=match):
            harness.make_train_step(load_config(overrides=dict(cfg, **over)), model, opt, 10)
    r = np.random.default_rng(5)
    batch = {"rgb": r.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8),
             "keypoint_mask": (r.random((2, 64, 64)) < 0.1).astype(np.uint8) * 255,
             "road_mask": (r.random((2, 64, 64)) < 0.3).astype(np.uint8) * 255,
             "graph_points": r.uniform(0, 64, (2, 16, 2)).astype(np.float32),
             "pairs": r.integers(0, 16, (2, 4, 4, 2)).astype(np.int32),
             "connected": r.random((2, 4, 4)) < 0.4, "valid": r.random((2, 4, 4)) < 0.7}
    trainer = harness.Trainer(cfg, model, str(tmp_path), steps_per_epoch=10, device="cpu",
                              log_every=1)
    before = model.image_encoder.blocks[0].attn.qkv.weight.detach().clone()
    losses = [trainer.train_epoch([batch], 0)[0]["loss"] for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert (model.image_encoder.blocks[0].attn.qkv.weight - before).abs().max() > 0
    assert [h["skipped"] for h in trainer.history] == [0.0] * 4
