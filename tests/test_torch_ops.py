"""The port's kernel modules (sam_road_tpu_torch/ops) against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

On CPU tensors each wrapper takes its plain PyTorch version, so these tests
hold that version to the Pallas kernel in fp32 (atol = rtol = 1e-5: the
same math, summed in another order). The CUDA kernels themselves are held
to these plain versions in tests/test_torch_cuda_kernels.py.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sam_road_tpu.ops import attention as jattn
from sam_road_tpu.ops import fused_block as jblock
from sam_road_tpu.ops import fused_ln as jln
from sam_road_tpu_torch import _native
from sam_road_tpu_torch.ops import attention, fused_block, fused_ln, sampling
from sam_road_tpu_torch.ops import _build

TOL = dict(atol=1e-5, rtol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def _ln_inputs(seed, M=64, C=64, F=192):
    r = _rng(seed)
    x = r.normal(size=(M, C)).astype(np.float32)
    s = (1 + 0.1 * r.normal(size=C)).astype(np.float32)
    b = (0.1 * r.normal(size=C)).astype(np.float32)
    w = (r.normal(size=(C, F)) / np.sqrt(C)).astype(np.float32)  # JAX (in, out)
    bias = (0.1 * r.normal(size=F)).astype(np.float32)
    return x, s, b, w, bias


@pytest.mark.parametrize("with_bias", [False, True])
def test_ln_dense_plain_matches_pallas(with_bias):
    x, s, b, w, bias = _ln_inputs(0)
    want = jln.ln_dense(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), jnp.asarray(w),
                        jnp.asarray(bias) if with_bias else None, interpret=True)
    t = torch.from_numpy
    got = fused_ln.ln_dense(t(x), t(s), t(b), t(w.T.copy()), t(bias) if with_bias else None)
    _close(got, want)


def test_proj_ln_mlp_residual_plain_matches_pallas():
    r = _rng(1)
    M, C, Hd = 64, 64, 256

    def n(*shape, scale=1.0):
        return (scale * r.normal(size=shape)).astype(np.float32)

    x, a = n(M, C), n(M, C)
    wp, bp = n(C, C, scale=C ** -0.5), n(C, scale=0.1)
    s, b = 1 + n(C, scale=0.1), n(C, scale=0.1)
    w1, b1 = n(C, Hd, scale=C ** -0.5), n(Hd, scale=0.1)
    w2, b2 = n(Hd, C, scale=Hd ** -0.5), n(C, scale=0.1)
    want = jln.proj_ln_mlp_residual(*map(jnp.asarray, (x, a, wp, bp, s, b, w1, b1, w2, b2)),
                                    interpret=True)
    t = torch.from_numpy
    got = fused_ln.proj_ln_mlp_residual(t(x), t(a), t(wp.T.copy()), t(bp), t(s), t(b),
                                        t(w1.T.copy()), t(b1), t(w2.T.copy()), t(b2))
    _close(got, want)


def test_window_attention_plain_matches_pallas_with_pad_tokens():
    """A 6x6 grid padded to 8x8 at window 4 with 2 heads: the pad tokens are
    zero in the bias-free grid and become `bias` keys in the kernel."""
    r = _rng(2)
    B, H, win, heads, C = 2, 6, 4, 2, 64
    Hp = 8
    grid = np.zeros((B, Hp, Hp, 3 * C), np.float32)
    grid[:, :H, :H] = r.normal(size=(B, H, H, 3 * C))
    bias = (0.5 * r.normal(size=3 * C)).astype(np.float32)
    rows = (B, Hp // win, Hp // win, heads, win * win, win)
    bh = r.normal(size=rows).astype(np.float32)
    bw = r.normal(size=rows).astype(np.float32)
    want = jblock.window_attention_rows_grid(jnp.asarray(grid), jnp.asarray(bias),
                                             jnp.asarray(bh), jnp.asarray(bw), win,
                                             heads, interpret=True)
    t = torch.from_numpy
    got = fused_block.window_attention_rows_grid(t(grid), t(bias), t(bh), t(bw), win, heads)
    _close(got, want)


def test_attention_relpos_rows_plain_matches_pallas():
    r = _rng(3)
    B, heads, H, W, D = 2, 2, 6, 6, 32
    N = H * W
    q = (r.normal(size=(B, heads, N, D)) * D ** -0.5).astype(np.float32)
    k, v = (r.normal(size=(B, heads, N, D)).astype(np.float32) for _ in range(2))
    bh = r.normal(size=(B, heads, N, H)).astype(np.float32)
    bw = r.normal(size=(B, heads, N, W)).astype(np.float32)
    want = jattn.attention_relpos_rows(*map(jnp.asarray, (q, k, v, bh, bw)), (H, W), True)
    t = torch.from_numpy
    got = attention.attention_relpos_rows(t(q), t(k), t(v), t(bh), t(bw), (H, W))
    _close(got, want)


@pytest.mark.parametrize("B,H,N,D,dv", [
    (1, 2, 196, 60, 32),   # a vit_t window: 14 x 14 tokens, head_dim 32 + 14 + 14
    (1, 2, 1024, 128, 64),  # the ViT-B 512 px global grid
    (1, 1, 4096, 192, 64),  # the 1024 px config's global grid (the blocked kernel)
    (1, 2, 196, 92, 64),   # a ViT-B window: ragged N, D 92 (instance 96)
    (1, 2, 256, 112, 80),  # vit_h's 256 px global grid: D 112, dv 80
])
def test_fused_attention_matches_pallas_forward_and_vjp(B, H, N, D, dv):
    """K5 on CPU (plain forward, recompute backward) against the JAX
    fused_attention in interpret mode and its custom_vjp, in fp32."""
    import jax

    r = _rng(N)
    q = (r.normal(size=(B, H, N, D)) * D ** -0.5).astype(np.float32)
    k = r.normal(size=(B, H, N, D)).astype(np.float32)
    v, g = (r.normal(size=(B, H, N, dv)).astype(np.float32) for _ in range(2))
    want, vjp = jax.vjp(lambda *a: jattn.fused_attention(*a, True), *map(jnp.asarray, (q, k, v)))
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    got = attention.fused_attention(*leaves)
    got.backward(torch.from_numpy(g))
    _close(got, want)
    for leaf, grad in zip(leaves, vjp(jnp.asarray(g))):
        _close(leaf.grad, grad)
    assert not _build.launches  # no kernel launched on CPU tensors


@pytest.mark.parametrize("hd,H,W", [
    (32, 14, 14),  # a vit_t window: D 60, padded to 64
    (32, 8, 8),    # a vit_t global grid: D 48, no padding
    (16, 7, 7),    # D 30, padded to 32
])
def test_padded_fold_attends_as_the_jax_unpadded_fold(hd, H, W):
    """models/vit.py::fold_rel_pos_qk pads q~ and k~ with zero columns to a
    multiple of 16 (K5's kernel copies 16-byte rows); the attention over the
    padded fold equals the JAX fused_attention (interpret mode) over the JAX
    package's unpadded fold, forward and VJP into q and k, in fp32."""
    import jax

    from sam_road_tpu.models import vit as jvit
    from sam_road_tpu_torch.models import vit

    r = _rng(hd + H)
    N, scale = H * W, hd ** -0.5
    q, k, v, g = (r.normal(size=(1, 2, N, hd)).astype(np.float32) for _ in range(4))
    Rh = (0.3 * r.normal(size=(H, H, hd))).astype(np.float32)
    Rw = (0.3 * r.normal(size=(W, W, hd))).astype(np.float32)

    def jax_attn(q, k, v):
        qa, ka = jvit.fold_rel_pos_qk(q, k, jnp.asarray(Rh), jnp.asarray(Rw), (H, W), scale)
        return jattn.fused_attention(qa, ka, v, True)

    want, vjp = jax.vjp(jax_attn, *map(jnp.asarray, (q, k, v)))
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    qa, ka = vit.fold_rel_pos_qk(leaves[0], leaves[1], torch.from_numpy(Rh),
                                 torch.from_numpy(Rw), (H, W), scale)
    D = hd + H + W
    assert qa.shape[-1] == ka.shape[-1] == -(-D // 16) * 16
    assert not qa[..., D:].any() and not ka[..., D:].any()
    got = attention.fused_attention(qa, ka, leaves[2])
    got.backward(torch.from_numpy(g))
    _close(got, want)
    for leaf, grad in zip(leaves, vjp(jnp.asarray(g))):
        _close(leaf.grad, grad)


@pytest.mark.parametrize("D,dv,want", [
    (92, 64, None), (96, 64, (96, 64)), (104, 64, (128, 64)), (128, 64, (128, 64)),
    (136, 64, (192, 64)), (192, 64, (192, 64)), (108, 80, None), (112, 80, (112, 80)),
    (104, 80, (112, 80)), (200, 64, None), (120, 80, None), (96, 32, None), (96, 128, None),
    (64, 32, (64, 32)), (56, 32, (64, 32)), (60, 32, None), (72, 32, None),
])
def test_folded_instance_choice(D, dv, want):
    """K5's instance (DQK, HD) for a contraction width D and value width dv:
    the narrowest DQK >= D at HD == dv, D a multiple of 8 (16-byte rows:
    the unpadded folds' 92 and 108 are not, fold_rel_pos_qk's 96 and 112
    are); any other (D, dv) raises ValueError naming the instances."""
    if want is None:
        with pytest.raises(ValueError, match="instances"):
            attention.folded_instance(D, dv)
    else:
        assert attention.folded_instance(D, dv) == want


@pytest.mark.parametrize("N,K,want", [
    (2304, 768, 256), (768, 3072, 256), (3840, 1280, 256), (256, 256, 256),
    (384, 768, 128), (640, 256, 128), (192, 64, None), (256, 96, None), (100, 64, None),
])
def test_gemm_block_n_shape_rules(N, K, want):
    """csrc/gemm.cu's shape rules as the wrappers apply them: a 256-wide
    block where N % 256 == 0, else 128 when N % 128 == 0; K a multiple of
    the 64-deep K tile; anything else raises ValueError."""
    if want is None:
        with pytest.raises(ValueError, match="N % 128 == 0 and K % 64 == 0"):
            _build.gemm_block_n(N, K, "ln_dense")
    else:
        assert _build.gemm_block_n(N, K, "ln_dense") == want


def test_wrappers_take_plain_version_on_cpu_and_refuse_other_devices():
    x, s, b, w, bias = map(torch.from_numpy, _ln_inputs(4))
    w = w.T.contiguous()
    torch.testing.assert_close(fused_ln.ln_dense(x, s, b, w, bias),
                               fused_ln.ln_dense_plain(x, s, b, w, bias), rtol=0, atol=0)
    with pytest.raises(ValueError, match="device"):
        fused_ln.ln_dense(x.to("meta"), s, b, w, bias)
    q = torch.ones(1, 1, 4, 8)
    with pytest.raises(ValueError, match="device"):
        attention.fused_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    assert not _build.launches  # no kernel launched on CPU tensors


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_require_refuses_a_tensor_off_the_card(device):
    """_build.require, which every wrapper's CUDA path runs, raises
    ValueError for a tensor that is not on a card, whatever its dtype."""
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        _build.require(torch.zeros(4, device=device), "x", torch.float32)


def test_failed_native_build_raises():
    with pytest.raises(RuntimeError, match="not found"):
        _native.build_and_load("nothing", "no-such-compiler-xyz", [], [])


def test_native_build_keeps_the_compiler_log(tmp_path):
    """A built library has what its compilers printed beside it, in
    <library>.log: for the CUDA kernels, ptxas's registers and spills."""
    src = tmp_path / "warns.cc"
    src.write_text('extern "C" int one() { int unused_here; return 1; }\n')
    lib = _native.build_and_load("logcheck", "g++", ["-shared", "-fPIC", "-Wall"], [str(src)])
    assert lib.one() == 1
    log = os.path.join(_native.BUILD_DIR, os.path.basename(lib._name) + ".log")
    with open(log) as f:
        assert "unused_here" in f.read()


def test_bilinear_sample_points_matches_jax_including_outside_points():
    from sam_road_tpu.ops.sampling import bilinear_sample_points as jsample

    r = _rng(5)
    feats = r.normal(size=(2, 6, 6, 8)).astype(np.float32)
    pts = r.uniform(-12, 76, size=(2, 40, 2)).astype(np.float32)
    pts[0, :4] = [[0, 0], [64, 64], [-5, 30], [70, 10]]  # corners and outside
    want = jsample(jnp.asarray(feats), jnp.asarray(pts), 64)
    got = sampling.bilinear_sample_points(torch.from_numpy(feats), torch.from_numpy(pts), 64)
    _close(got, want)
