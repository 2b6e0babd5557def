"""The PAD_FREE and WIN_* paths of the port (K7 ln_dense_padded, K8
proj_ln_mlp_residual_grid, K10 window_attention_rows_grid's rolled_rows /
group_batch modes, and models/fast_encoder.py's switches) against the JAX
package on the CPU.

The port's plain versions (what a CPU tensor takes) against the Pallas
kernels in interpret mode, on numpy inputs from a seed in fp32 at
tests/test_fused_attention.py's shapes (B 2, a 6x10 grid, window 4, which
pads to 8x12): rtol = atol = 2e-5, the same math summed in another order.
The encoder with the switches on against JAX's encoder_forward_fused with
the same switches (toggled and restored): vit_t, 96 px, window 4, fp32,
rtol = atol = 2e-4, tests/test_fast_encoder.py's bound.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sam_road_tpu.models import fast_encoder as jfe
from sam_road_tpu.models.vit import ENCODER_SPECS
from sam_road_tpu.models.vit import ImageEncoderViT as JImageEncoderViT
from sam_road_tpu.ops import fused_block as jfused_block
from sam_road_tpu.ops import fused_ln as jfused_ln
from sam_road_tpu_torch.models import fast_encoder as tfe
from sam_road_tpu_torch.models.convert import load_flax_params
from sam_road_tpu_torch.models.vit import ImageEncoderViT
from sam_road_tpu_torch.ops import fused_block, fused_ln

TOL = dict(rtol=2e-5, atol=2e-5)
B, H, W, WIN, HEADS, HD = 2, 6, 10, 4, 2, 8
C = HEADS * HD
PAD = ((WIN - H % WIN) % WIN, (WIN - W % WIN) % WIN)  # 6x10 -> 8x12


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_ln_dense_padded_plain_matches_jax():
    r = _rng(30)
    x = r.normal(size=(B, H, W, C)).astype(np.float32)
    s, b = (1 + 0.1 * r.normal(size=C)).astype(np.float32), (0.1 * r.normal(size=C)).astype(np.float32)
    w = (r.normal(size=(C, 3 * C)) * C ** -0.5).astype(np.float32)  # JAX layout [in, out]
    want = np.asarray(jfused_ln.ln_dense_padded(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                                                jnp.asarray(w), PAD, interpret=True))
    got = fused_ln.ln_dense_padded(_t(x), _t(s), _t(b), _t(w.T), PAD)
    assert got.shape == (B, H + PAD[0], W + PAD[1], 3 * C) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[:, H:].any() and not got[:, :, W:].any()  # pads exactly zero


def test_proj_ln_mlp_residual_grid_plain_matches_jax():
    r = _rng(31)
    hidden = 4 * C
    x = r.normal(size=(B, H, W, C)).astype(np.float32)
    a = r.normal(size=(B, H + PAD[0], W + PAD[1], C)).astype(np.float32)  # pads not zero:
    # the tail must read only the real tokens
    wp, w1, w2 = ((r.normal(size=shape) * shape[0] ** -0.5).astype(np.float32)
                  for shape in ((C, C), (C, hidden), (hidden, C)))
    bp, s, bb, b1, b2 = (v.astype(np.float32) for v in (
        0.1 * r.normal(size=C), 1 + 0.1 * r.normal(size=C), 0.1 * r.normal(size=C),
        0.1 * r.normal(size=hidden), 0.1 * r.normal(size=C)))
    want = np.asarray(jfused_ln.proj_ln_mlp_residual_grid(
        *map(jnp.asarray, (x, a, wp, bp, s, bb, w1, b1, w2, b2)), interpret=True))
    got = fused_ln.proj_ln_mlp_residual_grid(
        _t(x), _t(a), _t(wp.T), _t(bp), _t(s), _t(bb), _t(w1.T), _t(b1), _t(w2.T), _t(b2))
    assert got.shape == (B, H, W, C)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.fixture(scope="module")
def window_inputs():
    """tests/test_fused_attention.py's grid case: the bias-free padded qkv
    grid, the qkv bias and the bias rows with the analytic qb.R term."""
    r = _rng(21)
    Hp, Wp = H + PAD[0], W + PAD[1]
    nI, nJ, N = Hp // WIN, Wp // WIN, WIN * WIN
    qkv_nb = r.normal(size=(B, H, W, 3 * C)).astype(np.float32)
    bias = (r.normal(size=3 * C) * 0.2).astype(np.float32)
    rh, rw = ((r.normal(size=(2 * WIN - 1, HD)) * 0.1).astype(np.float32) for _ in range(2))
    qkv_p = np.pad(qkv_nb, ((0, 0), (0, PAD[0]), (0, PAD[1]), (0, 0)))
    coords = np.arange(WIN)[:, None] - np.arange(WIN)[None, :] + WIN - 1
    Rh, Rw = rh[coords], rw[coords]
    q_p = qkv_p[..., :C].reshape(B, nI, WIN, nJ, WIN, HEADS, HD)
    bias_q = bias[:C].reshape(HEADS, HD)
    bh = (np.einsum("bIiJjhc,iac->bIJhija", q_p, Rh)
          + np.einsum("hc,iac->hia", bias_q, Rh)[None, None, None, :, :, None, :])
    bw = (np.einsum("bIiJjhc,jac->bIJhija", q_p, Rw)
          + np.einsum("hc,jac->hja", bias_q, Rw)[None, None, None, :, None, :, :])
    return tuple(a.astype(np.float32) for a in (
        qkv_p, bias, bh.reshape(B, nI, nJ, HEADS, N, WIN), bw.reshape(B, nI, nJ, HEADS, N, WIN)))


@pytest.mark.parametrize("mode", [dict(), dict(rolled_rows=True), dict(group_batch=2),
                                  dict(group_batch=4), dict(group_batch=3, rolled_rows=True)])
def test_window_attention_rows_grid_modes_plain_match_jax(window_inputs, mode):
    """K10: every granularity computes K2's function; group_batch 3 halves to
    1 (B = 2) and then rolled_rows applies, as in JAX."""
    want = np.asarray(jfused_block.window_attention_rows_grid(
        *map(jnp.asarray, window_inputs), WIN, HEADS, interpret=True, **mode))
    got = fused_block.window_attention_rows_grid(*map(_t, window_inputs), WIN, HEADS, **mode)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("group_batch,B_,want", [(1, 32, 1), (4, 32, 4), (4, 6, 2), (8, 5, 1),
                                                 (3, 32, 1)])
def test_group_size_follows_the_jax_halving_rule(group_batch, B_, want):
    assert fused_block.group_size(group_batch, B_) == want


@pytest.fixture(scope="module")
def encoders():
    spec = ENCODER_SPECS["vit_t"]
    kw = dict(img_size=96, embed_dim=spec["embed_dim"], depth=spec["depth"],
              num_heads=spec["num_heads"], global_attn_indexes=spec["global_attn_indexes"],
              window_size=4)
    x = _rng(11).normal(size=(2, 96, 96, 3)).astype(np.float32)
    jenc = JImageEncoderViT(**kw, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(x))
                          ["params"])
    r = _rng(12)
    params = jax.tree.map(lambda p: p + 0.02 * r.normal(size=p.shape).astype(p.dtype), params)
    return params, load_flax_params(ImageEncoderViT(**kw), params, scope="image_encoder"), x


SWITCHES = [dict(PAD_FREE=True), dict(PAD_FREE=True, WIN_GROUP_BATCH=2),
            dict(WIN_ROLLED_ROWS=True)]


@pytest.mark.parametrize("switches", SWITCHES)
def test_fused_encoder_switches_match_jax(encoders, switches, monkeypatch):
    params, tenc, x = encoders
    for name, value in switches.items():
        monkeypatch.setattr(jfe, name, value)
        monkeypatch.setattr(tfe, name, value)
    want = np.asarray(jfe.encoder_forward_fused(params, jnp.asarray(x), sam_version="vit_t",
                                                img_size=96, window_size=4, dtype=jnp.float32,
                                                interpret=True))
    got = tfe.encoder_forward_fused(tenc, _t(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_switches_route_the_inference_path_only(encoders, monkeypatch):
    """PAD_FREE sends the 1 windowed block of vit_t (of 2) through K7 and K8
    on the inference path, never on the differentiable one; WIN_* reach
    window attention only on the inference path."""
    _, tenc, x = encoders
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append((name, {key: k[key] for key in ("rolled_rows", "group_batch")
                                 if key in k}))
            return fn(*a, **k)
        monkeypatch.setattr(tfe, name, wrapped)

    for name in ("ln_dense_padded", "proj_ln_mlp_residual_grid", "window_attention_rows_grid",
                 "ln_dense", "proj_ln_mlp_residual"):
        spy(name, getattr(tfe, name))
    monkeypatch.setattr(tfe, "PAD_FREE", True)
    monkeypatch.setattr(tfe, "WIN_GROUP_BATCH", 2)
    monkeypatch.setattr(tfe, "WIN_ROLLED_ROWS", True)
    tfe.encoder_forward_fused(tenc, _t(x))
    assert sorted(n for n, _ in calls) == sorted([
        "ln_dense_padded", "window_attention_rows_grid", "proj_ln_mlp_residual_grid",
        "ln_dense", "proj_ln_mlp_residual"])
    assert dict(calls)["window_attention_rows_grid"] == dict(rolled_rows=True, group_batch=2)
    calls.clear()
    tfe.encoder_forward_fused(tenc, _t(x), differentiable=True).sum().backward()
    assert [n for n, _ in calls] == []  # the K6 wrappers take over, without K7, K8 or K10
