"""K9 (ln_mlp_residual) and K11-K13 (window_attention_rows,
window_attention_relpos, window_attention_relpos_batched) of the port
against the JAX package's Pallas kernels in interpret mode on the CPU, and
the port's two tools (sam_road_tpu_torch/tools) at a tiny geometry.

On CPU tensors the wrappers take their plain PyTorch versions, so these tests
hold those to the Pallas kernels in fp32, at the JAX tests' sizes (window 4,
2 heads, head_dim 8, 6 windows) and tolerances: 3e-5 for K9 as
tests/test_fused_ln.py, 2e-5 for K11-K13 as tests/test_fused_attention.py
(the same math summed in another order). The `hd80` cases, and the K2 and
K3 tests here, run vit_h's head_dim 80, where the JAX window body takes its
non-merged branch (the scale after the fp32 product). The CUDA kernels are
held to these plain versions in tests/test_torch_cuda_kernels.py.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sam_road_tpu.ops import attention as jattn
from sam_road_tpu.ops import fused_block as jblock
from sam_road_tpu.ops import fused_ln as jln
from sam_road_tpu_torch.ops import attention, fused_block, fused_ln
from sam_road_tpu_torch.tools import experiment_fused_ln, profile_windowed_block

WIN, HEADS, HD, NW = 4, 2, 8, 6
N, C = WIN * WIN, HEADS * HD
TOL = dict(rtol=2e-5, atol=2e-5)
t = torch.from_numpy
# head_dim 8 at groups 1-3 (the JAX tests' size), and vit_h's head_dim 80
GROUP_HD = pytest.mark.parametrize("group,hd", [(1, HD), (2, HD), (3, HD), (1, 80)],
                                   ids=["1", "2", "3", "hd80"])


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def _mlp_inputs(seed, M=64, C=64, H=256):
    r = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (scale * r.normal(size=shape)).astype(np.float32)

    return (n(M, C), 1 + n(C, scale=0.1), n(C, scale=0.1), n(C, H, scale=C ** -0.5),
            n(H, scale=0.1), n(H, C, scale=H ** -0.5), n(C, scale=0.1))


def test_ln_mlp_residual_plain_matches_pallas():
    """K9 against fused_ln.py::ln_mlp_residual (weights transposed to the
    port's nn.Linear layout)."""
    x, s, b, w1, b1, w2, b2 = _mlp_inputs(0)
    want = jln.ln_mlp_residual(*map(jnp.asarray, (x, s, b, w1, b1, w2, b2)), tile=16, chunks=4,
                               interpret=True)
    got = fused_ln.ln_mlp_residual(t(x), t(s), t(b), t(w1.T.copy()), t(b1), t(w2.T.copy()),
                                   t(b2))
    _close(got, want, rtol=3e-5, atol=3e-5)


def test_ln_mlp_residual_after_projection_is_proj_ln_mlp_residual():
    """x1 = x + a.Wp + bp, then K9, equals K4 on (x, a), as
    tests/test_fused_ln.py holds the two Pallas kernels to each other."""
    x, s, b, w1, b1, w2, b2 = _mlp_inputs(1)
    r = np.random.default_rng(2)
    a = r.normal(size=x.shape).astype(np.float32)
    wp = (r.normal(size=(64, 64)) / 8).astype(np.float32)
    bp = (0.1 * r.normal(size=64)).astype(np.float32)
    x1 = x + a @ wp + bp
    w1t, w2t = t(w1.T.copy()), t(w2.T.copy())
    two = fused_ln.ln_mlp_residual(t(x1), t(s), t(b), w1t, t(b1), w2t, t(b2))
    fused = fused_ln.proj_ln_mlp_residual(t(x), t(a), t(wp.T.copy()), t(bp), t(s), t(b), w1t,
                                          t(b1), w2t, t(b2))
    _close(two, fused.numpy(), rtol=3e-5, atol=3e-5)


def _window_inputs(seed, hd=HD):
    r = np.random.default_rng(seed)
    qkv = r.normal(size=(NW, N, 3 * HEADS * hd)).astype(np.float32)
    rh = (0.1 * r.normal(size=(2 * WIN - 1, hd))).astype(np.float32)
    rw = (0.1 * r.normal(size=(2 * WIN - 1, hd))).astype(np.float32)
    return qkv, rh, rw


def _bias_rows(qkv, rh, rw):
    """bh = q.Rh, bw = q.Rw [nW, heads, N, win], as the JAX tests make them."""
    hd = rh.shape[-1]
    coords = np.arange(WIN)[:, None] - np.arange(WIN)[None, :] + WIN - 1
    q = qkv[..., :HEADS * hd].reshape(-1, WIN, WIN, HEADS, hd)
    bh = np.einsum("wijhc,iac->whija", q, rh[coords]).reshape(-1, HEADS, N, WIN)
    bw = np.einsum("wijhc,jac->whija", q, rw[coords]).reshape(-1, HEADS, N, WIN)
    return bh.astype(np.float32), bw.astype(np.float32)


@GROUP_HD
def test_window_attention_rows_plain_matches_pallas(group, hd):
    """K11 against fused_block.py::window_attention_rows at each group."""
    qkv, rh, rw = _window_inputs(7, hd)
    bh, bw = _bias_rows(qkv, rh, rw)
    want = jblock.window_attention_rows(*map(jnp.asarray, (qkv, bh, bw)), WIN, HEADS,
                                        interpret=True, group=group)
    _close(fused_block.window_attention_rows(t(qkv), t(bh), t(bw), WIN, HEADS, group=group),
           want)


@GROUP_HD
def test_window_attention_relpos_plain_matches_pallas(group, hd):
    """K12 against fused_block.py::window_attention_relpos; every group
    gives group 1's output exactly."""
    qkv, rh, rw = _window_inputs(5, hd)
    want = jblock.window_attention_relpos(*map(jnp.asarray, (qkv, rh, rw)), WIN, HEADS,
                                          interpret=True)
    got = fused_block.window_attention_relpos(t(qkv), t(rh), t(rw), WIN, HEADS, group=group)
    _close(got, want)
    one = fused_block.window_attention_relpos(t(qkv), t(rh), t(rw), WIN, HEADS)
    assert torch.equal(got, one)


@GROUP_HD
def test_window_attention_relpos_batched_plain_matches_pallas(group, hd):
    """K13 (its 16 -> 128 token padding included) against
    fused_block.py::window_attention_relpos_batched and against the port's
    K12 on the same tokens in window layout."""
    r = np.random.default_rng(5)
    q, k, v = (r.normal(size=(NW, HEADS, N, hd)).astype(np.float32) for _ in range(3))
    rh, rw = ((0.1 * r.normal(size=(2 * WIN - 1, hd))).astype(np.float32) for _ in range(2))
    want = jblock.window_attention_relpos_batched(*map(jnp.asarray, (q, k, v, rh, rw)), WIN,
                                                  group=group, interpret=True)
    got = fused_block.window_attention_relpos_batched(t(q), t(k), t(v), t(rh), t(rw), WIN,
                                                      group=group)
    _close(got, want)
    qkv = np.concatenate([a.transpose(0, 2, 1, 3).reshape(NW, N, HEADS * hd)
                          for a in (q, k, v)], -1)
    k12 = fused_block.window_attention_relpos(t(qkv), t(rh), t(rw), WIN, HEADS)
    _close(got, k12.reshape(NW, N, HEADS, hd).permute(0, 2, 1, 3).numpy())


def _grid_case(seed, hd, bias_scale=1.0):
    """K2 on a 6x6 grid padded to 8x8 at window 4 (2 heads), bias rows
    scaled by bias_scale, against fused_block.py::window_attention_rows_grid."""
    r = np.random.default_rng(seed)
    B, H, Hp = 2, 6, 8
    C3 = 3 * HEADS * hd
    grid = np.zeros((B, Hp, Hp, C3), np.float32)
    grid[:, :H, :H] = r.normal(size=(B, H, H, C3))
    bias = (0.5 * r.normal(size=C3)).astype(np.float32)
    rows = (B, Hp // WIN, Hp // WIN, HEADS, N, WIN)
    bh, bw = ((bias_scale * r.normal(size=rows)).astype(np.float32) for _ in range(2))
    want = jblock.window_attention_rows_grid(*map(jnp.asarray, (grid, bias, bh, bw)), WIN,
                                             HEADS, interpret=True)
    _close(fused_block.window_attention_rows_grid(t(grid), t(bias), t(bh), t(bw), WIN, HEADS),
           want)


def _global_case(seed, D, bias_scale=1.0):
    """K3 on a 6x6 grid (2 heads), bias rows scaled by bias_scale, against
    attention.py::attention_relpos_rows."""
    r = np.random.default_rng(seed)
    B, H, W = 2, 6, 6
    q = (r.normal(size=(B, HEADS, H * W, D)) * D ** -0.5).astype(np.float32)
    k, v = (r.normal(size=(B, HEADS, H * W, D)).astype(np.float32) for _ in range(2))
    bh = (bias_scale * r.normal(size=(B, HEADS, H * W, H))).astype(np.float32)
    bw = (bias_scale * r.normal(size=(B, HEADS, H * W, W))).astype(np.float32)
    want = jattn.attention_relpos_rows(*map(jnp.asarray, (q, k, v, bh, bw)), (H, W), True)
    _close(attention.attention_relpos_rows(t(q), t(k), t(v), t(bh), t(bw), (H, W)), want)


def test_window_attention_rows_grid_plain_matches_pallas_at_head_dim_80():
    """K2 at vit_h's head_dim 80: the JAX body's non-merged branch, the
    scale after the fp32 product."""
    _grid_case(22, 80)


def test_attention_relpos_rows_plain_matches_pallas_at_head_dim_80():
    """K3 at head_dim 80 (vit_h's global blocks are 16x16 at 256 px)."""
    _global_case(23, 80)


@pytest.mark.parametrize("hd", [HD, 80], ids=["hd8", "hd80"])
def test_window_attention_rows_grid_plain_matches_pallas_with_peaked_scores(hd):
    """K2 with the bias rows scaled x8, as the CUDA tests' peaked cases:
    row maxima fall off the diagonal and p is nearly one-hot."""
    _grid_case(24, hd, bias_scale=8.0)


@pytest.mark.parametrize("hd", [HD, 80], ids=["hd8", "hd80"])
def test_attention_relpos_rows_plain_matches_pallas_with_peaked_scores(hd):
    """K3 with the bias rows scaled x8 (the CUDA tests' peaked cases)."""
    _global_case(25, hd, bias_scale=8.0)


def test_window_attention_rows_matches_grid_kernel_on_partitioned_grid():
    """K11 on the windows of a zero-padded grid (bias added, windows
    materialised) equals the port's K2 on the grid, the relation
    tests/test_fused_attention.py pins between the Pallas kernels; and the
    port's K11 equals the Pallas K11 there."""
    r = np.random.default_rng(21)
    B, H, W = 2, 6, 10  # pads to 8 x 12: 2 x 3 windows
    pad_h, pad_w = (WIN - H % WIN) % WIN, (WIN - W % WIN) % WIN
    Hp, Wp = H + pad_h, W + pad_w
    nI, nJ = Hp // WIN, Wp // WIN
    qkv_nb = r.normal(size=(B, H, W, 3 * C)).astype(np.float32)
    bias = (0.2 * r.normal(size=3 * C)).astype(np.float32)
    rh, rw = ((0.1 * r.normal(size=(2 * WIN - 1, HD))).astype(np.float32) for _ in range(2))
    qkv_p = np.pad(qkv_nb, ((0, 0), (0, pad_h), (0, pad_w), (0, 0)))
    qkv_w = (qkv_p + bias).reshape(B, nI, WIN, nJ, WIN, 3 * C).transpose(0, 1, 3, 2, 4, 5)
    qkv_w = np.ascontiguousarray(qkv_w.reshape(-1, N, 3 * C))
    coords = np.arange(WIN)[:, None] - np.arange(WIN)[None, :] + WIN - 1
    qw = qkv_w[..., :C].reshape(-1, WIN, WIN, HEADS, HD)
    bh_w = np.einsum("wijhc,iac->whija", qw, rh[coords]).reshape(-1, HEADS, N, WIN)
    bw_w = np.einsum("wijhc,jac->whija", qw, rw[coords]).reshape(-1, HEADS, N, WIN)
    got_w = fused_block.window_attention_rows(t(qkv_w), t(bh_w), t(bw_w), WIN, HEADS)
    want_w = jblock.window_attention_rows(*map(jnp.asarray, (qkv_w, bh_w, bw_w)), WIN, HEADS,
                                          interpret=True)
    _close(got_w, want_w)
    got = got_w.reshape(B, nI, nJ, WIN, WIN, C).permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)

    bh, bw = (a.reshape(B, nI, nJ, HEADS, N, WIN) for a in (bh_w, bw_w))
    k2 = fused_block.window_attention_rows_grid(t(qkv_p), t(bias), t(bh), t(bw), WIN, HEADS)
    _close(got, k2.numpy())


def test_group_size_follows_the_jax_halving_rule():
    """`group` halved until it divides the window count (fused_block.py:148-150)."""
    for group, n in [(4, 288), (4, 6), (3, 6), (4, 9), (8, 12), (1, 5)]:
        g = group
        while g > 1 and n % g:
            g //= 2
        assert fused_block.group_size(group, n) == g


TINY = dict(tokens=64, dim=32, windows=4, win=4, heads=2, iters=2, rounds=2)


def test_experiment_fused_ln_runs_every_variant_on_cpu():
    """The kernel A/B tool at a tiny geometry on the CPU: every variant's
    _l1 and _ms present and finite, each kernel's _l1 within 1e-2 of its
    plain counterpart's (on the CPU both take the plain version)."""
    res = experiment_fused_ln.main("all", device="cpu", **TINY)
    labels = ["plain_ln_dense", "cuda_ln_dense", "plain_ln_mlp", "cuda_ln_mlp", "fold_attn",
              "cuda_window_attn", "cuda_rows_g1", "cuda_rows_g2", "cuda_rows_g4",
              "cuda_batched_attn", "plain_textbook_attn"]
    assert sorted(res) == sorted(f"{lb}_{k}" for lb in labels for k in ("l1", "ms"))
    assert all(math.isfinite(v) and v > 0 for v in res.values())
    for kern, plain in experiment_fused_ln.PAIRS.items():
        assert abs(res[f"{kern}_l1"] / res[f"{plain}_l1"] - 1) <= 1e-2, kern


def test_profile_windowed_block_runs_every_stage_on_cpu():
    """The windowed-block profiler at a tiny geometry on the CPU: every stage
    prefix ran and has a finite time."""
    res = profile_windowed_block.main(device="cpu", batch=1, grid=6, dim=32, heads=2, ws=4,
                                      iters=1, rounds=1)
    assert list(res) == [f"{s}_ms" for s in profile_windowed_block.STAGES]
    assert all(math.isfinite(v) and v > 0 for v in res.values())
