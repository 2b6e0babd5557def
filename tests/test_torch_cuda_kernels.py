"""The port's CUDA kernels against their plain PyTorch versions, in bf16 at
the bench shapes (ViT-B at 512 px: C 768, 12 heads, 32x32 token grid,
window 14), the attention kernels with peaked scores (bias x 8) at head_dim
64 and 80, the K6 wrappers' forward and gradients at the training shapes
(the same at batch 16), and the grid modes K7, K8 and K10 bit-equal to the
kernels they vary (K1 + pad, K4 on the cropped input, K2), and K9, K11, K12
and K13 at the tools' shapes (groups bit-equal), K2, K3 and K10-K13 at
vit_h's head_dim 80 (C 1280, 16 heads; at 256 px a 16x16 grid padded to
28x28), the tools' kernels T1-T4 (T3 bit-equal to T2 at every G), T5 on a
window and on the global grid, T6-T8 at the probes' shapes and T7 / T8 at
ragged ones (one key to 1000, scores all negative), and T9-T13 at the
probes' shapes and at ragged ones (T9 / T10 bit-equal to plain, T12 to
T11, also at C 99 and at 70000 rows, T13's two launch shapes to each
other), and K5's fp32 kernel at every instance, at ragged N and at B x
heads past 65535, on an NVIDIA GPU.

The kernels have no CPU mode, so every test here is marked `cuda` and skips
where torch sees no GPU. This file imports neither jax nor the JAX package,
so it also runs on the card's machine:
    python -m pytest tests/test_torch_cuda_kernels.py -q
"""

import math

import pytest
import torch

from sam_road_tpu_torch.ops import _build, attention, fused_block, fused_ln
from sam_road_tpu_torch.tools import (
    experiment_block_variants,
    experiment_group_window,
    experiment_relpos_kernel,
    experiment_window_attn,
    probe_mosaic,
    probe_nondiv_blocks,
    repro_aot_crash,
)

VITH = dict(C=1280, heads=16, grid=16)  # vit_h at 256 px: head_dim 80


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bench_case(name, B, dev, C=768, heads=12, grid=32):
    """Inputs at the bench shapes (ViT-B, 512 px: C 768, 12 heads, 32x32
    grid, window 14; or VITH) for one kernel, bf16."""
    gen = torch.Generator(device=dev).manual_seed(7)
    bf = torch.bfloat16

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    hd, win = C // heads, 14
    M = B * grid * grid
    if name in ("ln_dense", "ln_dense_bias"):
        args = (rn(M, C), 1 + rn(C, scale=0.1), rn(C, scale=0.1),
                rn(3 * C, C, scale=C ** -0.5),
                rn(3 * C, scale=0.1) if name == "ln_dense_bias" else None)
        return fused_ln.ln_dense, fused_ln.ln_dense_plain, args
    if name == "proj_ln_mlp_residual":
        args = (rn(M, C), rn(M, C), rn(C, C, scale=C ** -0.5), rn(C, scale=0.1),
                1 + rn(C, scale=0.1), rn(C, scale=0.1), rn(4 * C, C, scale=C ** -0.5),
                rn(4 * C, scale=0.1), rn(C, 4 * C, scale=(4 * C) ** -0.5), rn(C, scale=0.1))
        return fused_ln.proj_ln_mlp_residual, fused_ln.proj_ln_mlp_residual_plain, args
    if name == "window_attention_rows_grid":
        nw = -(-grid // win)
        gp = nw * win
        qkv = torch.zeros((B, gp, gp, 3 * C), dtype=bf, device=dev)
        qkv[:, :grid, :grid] = rn(B, grid, grid, 3 * C)
        rows = (B, nw, nw, heads, win * win, win)
        args = (qkv, rn(3 * C, scale=0.5), rn(*rows), rn(*rows))
        return (lambda *a: fused_block.window_attention_rows_grid(*a, win, heads),
                lambda *a: fused_block.window_attention_rows_grid_plain(*a, win, heads), args)
    N = grid * grid
    q = (rn(B, heads, N, hd).float() * hd ** -0.5).to(bf)
    args = (q, rn(B, heads, N, hd), rn(B, heads, N, hd), rn(B, heads, N, grid),
            rn(B, heads, N, grid))
    return (lambda *a: attention.attention_relpos_rows(*a, (grid, grid)),
            lambda *a: attention.attention_relpos_rows_plain(*a, (grid, grid)), args)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ln_dense", "ln_dense_bias", "window_attention_rows_grid",
                                  "attention_relpos_rows", "proj_ln_mlp_residual"])
def test_cuda_kernel_matches_plain_at_bench_shapes(cuda, name):
    """|kernel - plain| <= 2e-2 (1 + |plain|), the plain version in fp32 on
    the same bf16 inputs (bf16 outputs; bf16 p and hidden in the kernels)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    kern, plain, args = _bench_case(name, 4, cuda)
    before = _build.launches.copy()
    got = kern(*args).float()
    torch.cuda.synchronize()
    ref = plain(*[a.float() if a is not None else None for a in args])
    assert torch.isfinite(got).all()
    assert ((got - ref).abs() / (1 + ref.abs())).max().item() <= 2e-2
    key = "ln_dense" if name.startswith("ln_dense") else name
    assert _build.launches[key] == before[key] + 1


def _folded_case(dev, B, side, heads, hd, seed=8, dtype=torch.bfloat16):
    """K5's inputs as the eager encoder builds them: q, k, v [B, heads, side^2,
    hd] and rel-pos tables through models/vit.py::fold_rel_pos_qk (q~ scaled,
    D = hd + 2 side padded to a multiple of 16), and a cotangent; in
    `dtype` (bf16 unless given)."""
    from sam_road_tpu_torch.models.vit import fold_rel_pos_qk

    gen = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    N = side * side
    q, k, v, g = (rn(B, heads, N, hd) for _ in range(4))
    Rh, Rw = (rn(side, side, hd, scale=0.3 * hd ** -0.5) for _ in range(2))
    q_aug, k_aug = fold_rel_pos_qk(q, k, Rh, Rw, (side, side), hd ** -0.5)
    return q_aug.contiguous(), k_aug.contiguous(), v, g


FOLDED_SHAPES = [
    (36, 14, 12, 64),  # ViT-B window: 196 tokens, D 92 -> instance 96
    (4, 16, 12, 64),   # 256 px global (ViT-B, vit_l): D 96
    (4, 32, 12, 64),   # 512 px global: D 128
    (1, 64, 12, 64),   # 1024 px global: D 192
    (16, 14, 16, 80),  # vit_h window: D 108 -> instance 112
    (4, 16, 16, 80),   # vit_h 256 px global: D 112
    (16, 14, 2, 32),   # vit_t window (head_dim 32): D 60 -> 64, instance (64, 32)
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,side,heads,hd", FOLDED_SHAPES)
def test_cuda_fused_attention_forward_and_backward(cuda, B, side, heads, hd):
    """K5 at every instance (DQK, HD) of csrc/relpos_attention.cu's
    MODE_FOLDED, on inputs folded as the encoder folds them, bf16: the
    forward and the autograd.Function's gradients within 2e-2 (1 + |ref|)
    of the plain version under autograd in fp32 on the same inputs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, g = _folded_case(cuda, B, side, heads, hd)
    before = _build.launches["fused_attention"]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = attention.fused_attention(*leaves)
    got.backward(g)
    torch.cuda.synchronize()
    assert _build.launches["fused_attention"] == before + 1
    refs = [t.float().requires_grad_() for t in (q, k, v)]
    ref = attention.fused_attention_plain(*refs)
    ref.backward(g.float())
    for a, b in [(got, ref)] + [(x.grad, y.grad) for x, y in zip(leaves, refs)]:
        assert torch.isfinite(a.float()).all()
        assert ((a.float() - b).abs() / (1 + b.abs())).max().item() <= 2e-2


# K5's fp32 kernel off the main path's shapes: ragged N (169 tokens: N % 16
# = 9; 25 tokens at D 80, a 16-column chunk past D in the 96 instance; 81 at
# vit_h's instance and at vit_t's) and B x heads = 70000 at 16 tokens, past
# the 65535 a grid's y could hold
FOLDED_F32_MORE = [
    (3, 13, 12, 64),
    (2, 5, 12, 64),
    (2, 9, 16, 80),
    (5000, 4, 14, 64),
    (3, 9, 2, 32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,side,heads,hd", FOLDED_SHAPES + FOLDED_F32_MORE)
def test_cuda_fused_attention_fp32_forward_and_backward(cuda, B, side, heads, hd):
    """K5's fp32 kernel (csrc/folded_attention_f32.cu: three TF32 products
    for each fp32 one) at every instance on fp32 inputs folded as the
    encoder folds them, and at ragged N and B x heads past 65535: the
    forward and the autograd.Function's gradients within 1e-4 (1 + |ref|)
    of the plain version under autograd on the same inputs (fp32 math, the
    products split into TF32 halves and summed in another order), counted
    as fused_attention_f32 and not as the bf16 kernel."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, g = _folded_case(cuda, B, side, heads, hd, dtype=torch.float32)
    before = dict(_build.launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = attention.fused_attention(*leaves)
    got.backward(g)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert _build.launches["fused_attention_f32"] == before.get("fused_attention_f32", 0) + 1
    assert _build.launches["fused_attention"] == before.get("fused_attention", 0)
    refs = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = attention.fused_attention_plain(*refs)
    ref.backward(g)
    for a, b in [(got, ref)] + [(x.grad, y.grad) for x, y in zip(leaves, refs)]:
        assert torch.isfinite(a).all()
        assert ((a - b).abs() / (1 + b.abs())).max().item() <= 1e-4


@pytest.mark.cuda
def test_cuda_fused_attention_refuses_other_dtypes(cuda):
    """K5 on fp16 (or mixed) inputs raises TypeError and launches nothing."""
    q = torch.zeros((1, 1, 196, 96), dtype=torch.float16, device=cuda)
    v = torch.zeros((1, 1, 196, 64), dtype=torch.float16, device=cuda)
    before = dict(_build.launches)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        attention.fused_attention(q, q, v)
    with pytest.raises(TypeError):
        attention.fused_attention(q.float(), q.float(), v)
    assert dict(_build.launches) == before


@pytest.mark.cuda
def test_cuda_fused_attention_refuses_rows_it_cannot_copy(cuda):
    """K5 on an unpadded 92-wide fold (184-byte rows) or a width no instance
    takes raises ValueError naming the instances, and launches nothing."""
    q = torch.zeros((1, 1, 196, 92), dtype=torch.bfloat16, device=cuda)
    v = torch.zeros((1, 1, 196, 64), dtype=torch.bfloat16, device=cuda)
    before = _build.launches["fused_attention"]
    with pytest.raises(ValueError, match="instances"):
        attention.fused_attention(q, q, v)
    wide = torch.zeros((1, 1, 196, 208), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="instances"):
        attention.fused_attention(wide, wide, v)
    assert _build.launches["fused_attention"] == before


def _k6_case(name, dev):
    """(K6 wrapper, plain version, bf16 inputs) at the training shapes
    (ViT-B 512 px, batch 16): ln_dense_d x [16384, 768], w [2304, 768];
    proj_ln_mlp_residual_d x, attn_out [16384, 768]; the window grid
    [16, 42, 42, 2304] with bias rows [16, 3, 3, 12, 196, 14]; global q, k,
    v [16, 12, 1024, 64] with bias rows [16, 12, 1024, 32]."""
    win, heads = 14, 12
    plain_name = {"ln_dense_d": "ln_dense", "ln_dense_bias_d": "ln_dense_bias"}.get(
        name, name[:-2])
    _, plain, args = _bench_case(plain_name, 16, dev)
    wrapper = {
        "ln_dense_d": lambda x, s, b, w, _: fused_ln.ln_dense_d(x, s, b, w),
        "ln_dense_bias_d": fused_ln.ln_dense_bias_d,
        "proj_ln_mlp_residual_d": fused_ln.proj_ln_mlp_residual_d,
        "window_attention_rows_grid_d":
            lambda *a: fused_block.window_attention_rows_grid_d(*a, win, heads),
        "attention_relpos_rows_d": lambda *a: attention.attention_relpos_rows_d(*a, (32, 32)),
    }[name]
    return wrapper, plain, args


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ln_dense_d", "ln_dense_bias_d", "proj_ln_mlp_residual_d",
                                  "window_attention_rows_grid_d", "attention_relpos_rows_d"])
def test_cuda_k6_forward_and_gradients_at_training_shapes(cuda, name):
    """The K6 wrapper (K1-K4 forward, recompute backward) against the plain
    version under autograd in fp32 on the same bf16 inputs, for a cotangent
    N(0, 1) / 128 (a loss's mean over the batch makes cotangents small):
    every output and input gradient within 2e-2 (1 + |ref|) elementwise and
    within 2e-2 of the tensor's largest |ref|; one counted launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    wrapper, plain, args = _k6_case(name, cuda)
    gen = torch.Generator(device=cuda).manual_seed(9)
    before = _build.launches[name]
    leaves = [None if a is None else a.clone().requires_grad_() for a in args]
    got = wrapper(*leaves)
    g = (torch.randn(got.shape, generator=gen, device=cuda) / 128).to(torch.bfloat16)
    got.backward(g)
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 1
    refs = [None if a is None else a.float().requires_grad_() for a in args]
    ref = plain(*refs)
    ref.backward(g.float())
    pairs = [(got, ref)] + [(a.grad, b.grad) for a, b in zip(leaves, refs) if a is not None]
    for a, b in pairs:
        err = (a.float() - b).abs()
        assert torch.isfinite(a.float()).all()
        assert (err / (1 + b.abs())).max().item() <= 2e-2
        assert err.max().item() <= 2e-2 * b.abs().max().item()


def _grid_case(B, dev):
    """K1's and K4's bench inputs as [B, 32, 32, C], and an attention output
    on the 42x42 padded grid whose pads are not zero."""
    _, _, ln_args = _bench_case("ln_dense", B, dev)
    _, _, tail_args = _bench_case("proj_ln_mlp_residual", B, dev)
    C = 768
    x = ln_args[0].reshape(B, 32, 32, C)
    a_pad = torch.randn((B, 42, 42, C), device=dev).to(torch.bfloat16)
    return x, ln_args[1:4], tail_args[0].reshape(B, 32, 32, C), a_pad, tail_args[2:]


@pytest.mark.cuda
def test_cuda_ln_dense_padded_is_k1_plus_pad(cuda):
    """K7: bit-equal to K1 on the real tokens, exact zeros in the pads, and
    within 2e-2 (1 + |plain|) of its plain version in fp32; one launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, (s, b, w), *_ = _grid_case(4, cuda)
    before = _build.launches["ln_dense_padded"]
    got = fused_ln.ln_dense_padded(x, s, b, w, (10, 10))
    torch.cuda.synchronize()
    assert _build.launches["ln_dense_padded"] == before + 1
    assert got.shape == (4, 42, 42, 2304)
    flat = fused_ln.ln_dense(x.reshape(-1, 768), s, b, w).reshape(4, 32, 32, 2304)
    assert torch.equal(got[:, :32, :32], flat)
    assert not got[:, 32:].any() and not got[:, :, 32:].any()
    ref = fused_ln.ln_dense_padded_plain(x.float(), s.float(), b.float(), w.float(), (10, 10))
    assert ((got.float() - ref).abs() / (1 + ref.abs())).max().item() <= 2e-2


@pytest.mark.cuda
def test_cuda_proj_ln_mlp_residual_grid_is_k4_on_the_crop(cuda):
    """K8: bit-equal to K4 on the cropped attention output, and within 2e-2
    (1 + |plain|) of its plain version in fp32; one launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _, _, x, a_pad, weights = _grid_case(4, cuda)
    before = _build.launches["proj_ln_mlp_residual_grid"]
    got = fused_ln.proj_ln_mlp_residual_grid(x, a_pad, *weights)
    torch.cuda.synchronize()
    assert _build.launches["proj_ln_mlp_residual_grid"] == before + 1
    flat = fused_ln.proj_ln_mlp_residual(x.reshape(-1, 768),
                                         a_pad[:, :32, :32].reshape(-1, 768).contiguous(),
                                         *weights).reshape(4, 32, 32, 768)
    assert torch.equal(got, flat)
    ref = fused_ln.proj_ln_mlp_residual_grid_plain(x.float(), a_pad.float(),
                                                   *[t.float() for t in weights])
    assert ((got.float() - ref).abs() / (1 + ref.abs())).max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("mode,name", [(dict(rolled_rows=True), "rolled"),
                                       (dict(group_batch=4), "gbatch"),
                                       (dict(group_batch=2, rolled_rows=True), "gbatch")])
def test_cuda_window_attention_modes_are_bit_equal_to_k2(cuda, mode, name):
    """K10: each granularity gives K2's output bit for bit and counts one
    launch under its own name."""
    kern, _, args = _bench_case("window_attention_rows_grid", 4, cuda)
    want = kern(*args)
    key = f"window_attention_rows_grid_{name}"
    before = _build.launches[key]
    got = fused_block.window_attention_rows_grid(*args, 14, 12, **mode)
    torch.cuda.synchronize()
    assert _build.launches[key] == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_ln_mlp_residual_matches_plain(cuda):
    """K9 (K4's last two launches over x) within 2e-2 (1 + |plain|) of its
    plain version in fp32 on the same bf16 inputs; one launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _, _, tail = _bench_case("proj_ln_mlp_residual", 4, cuda)
    args = (tail[0],) + tail[4:]  # x, ln2, W1, b1, W2, b2
    before = _build.launches["ln_mlp_residual"]
    got = fused_ln.ln_mlp_residual(*args).float()
    torch.cuda.synchronize()
    assert _build.launches["ln_mlp_residual"] == before + 1
    ref = fused_ln.ln_mlp_residual_plain(*[a.float() for a in args])
    assert torch.isfinite(got).all()
    assert ((got - ref).abs() / (1 + ref.abs())).max().item() <= 2e-2


def _window_layout_case(name, dev, nW=288, heads=12, hd=64):
    """(kernel taking group=, plain version, bf16 inputs) for K11-K13 at the
    tools' shapes: 288 windows of 14 x 14 tokens, C 768, 12 heads."""
    gen = torch.Generator(device=dev).manual_seed(12)
    N, win = 196, 14

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    qkv = rn(nW, N, 3 * heads * hd)
    tables = (rn(2 * win - 1, hd, scale=0.1), rn(2 * win - 1, hd, scale=0.1))
    if name == "window_attention_rows":
        return (lambda *a, group=1: fused_block.window_attention_rows(*a, win, heads, group=group),
                lambda *a: fused_block.window_attention_rows_plain(*a, win, heads),
                (qkv, rn(nW, heads, N, win), rn(nW, heads, N, win)))
    if name == "window_attention_relpos":
        return (lambda *a, group=1: fused_block.window_attention_relpos(*a, win, heads,
                                                                        group=group),
                lambda *a: fused_block.window_attention_relpos_plain(*a, win, heads),
                (qkv,) + tables)
    q, k, v = (t.contiguous() for t in qkv.reshape(nW, N, 3, heads, hd).permute(2, 0, 3, 1, 4))
    return (lambda *a, group=1: fused_block.window_attention_relpos_batched(*a, win,
                                                                           group=group),
            lambda *a: fused_block.window_attention_relpos_batched_plain(*a, win),
            (q, k, v) + tables)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["window_attention_rows", "window_attention_relpos",
                                  "window_attention_relpos_batched"])
def test_cuda_window_layout_kernels_match_plain_at_every_group(cuda, name):
    """K11, K12, K13: group 1 within 2e-2 (1 + |plain|) of the plain version
    in fp32 on the same bf16 inputs; groups 2, 3 and 4 bit-equal to group 1;
    one launch each."""
    torch.backends.cuda.matmul.allow_tf32 = False
    kern, plain, args = _window_layout_case(name, cuda)
    before = _build.launches[name]
    got = kern(*args)
    others = [kern(*args, group=g) for g in (2, 3, 4)]
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 4
    assert all(torch.equal(o, got) for o in others)
    ref = plain(*[a.float() for a in args])
    assert torch.isfinite(got.float()).all()
    assert ((got.float() - ref).abs() / (1 + ref.abs())).max().item() <= 2e-2


@pytest.mark.cuda
def test_cuda_window_attention_relpos_batched_is_relpos_on_split_heads(cuda):
    """K13 on head-split q, k, v equals K12 on the same tokens in window
    layout within 2e-2 (1 + |K12|): the same function."""
    _, _, (qkv, rh, rw) = _window_layout_case("window_attention_relpos", cuda)
    k12 = fused_block.window_attention_relpos(qkv, rh, rw, 14, 12).float()
    q, k, v = (t.contiguous() for t in qkv.reshape(288, 196, 3, 12, 64).permute(2, 0, 3, 1, 4))
    k13 = fused_block.window_attention_relpos_batched(q, k, v, rh, rw, 14)
    k13 = k13.permute(0, 2, 1, 3).reshape(288, 196, 768).float()
    assert ((k13 - k12).abs() / (1 + k12.abs())).max().item() <= 2e-2


def _within_tol(got, ref):
    """Finite and |got - ref| <= 2e-2 (1 + |ref|), ref in fp32."""
    return bool(torch.isfinite(got.float()).all()) and (
        (got.float() - ref).abs() / (1 + ref.abs())).max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["window_attention_rows_grid", "attention_relpos_rows"])
def test_cuda_attention_kernels_match_plain_at_head_dim_80(cuda, name):
    """K2 and K3 at vit_h's 256 px shapes (head_dim 80; 2 x 2 windows of
    14 x 14 on the padded grid, 256 global tokens) within 2e-2 (1 + |plain|)
    of the plain version in fp32; one launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    kern, plain, args = _bench_case(name, 4, cuda, **VITH)
    before = _build.launches[name]
    got = kern(*args)
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 1
    assert _within_tol(got, plain(*[a.float() for a in args]))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,name", [(dict(rolled_rows=True), "rolled"),
                                       (dict(group_batch=4), "gbatch")])
def test_cuda_window_attention_modes_are_bit_equal_to_k2_at_head_dim_80(cuda, mode, name):
    """K10 at head_dim 80 gives K2's output bit for bit."""
    kern, _, args = _bench_case("window_attention_rows_grid", 4, cuda, **VITH)
    want = kern(*args)
    got = fused_block.window_attention_rows_grid(*args, 14, 16, **mode)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["window_attention_rows", "window_attention_relpos",
                                  "window_attention_relpos_batched"])
def test_cuda_window_layout_kernels_match_plain_at_head_dim_80(cuda, name):
    """K11, K12, K13 at head_dim 80 (16 windows of vit_h's 256 px batch of
    4, 16 heads): within 2e-2 (1 + |plain|) of the plain version in fp32,
    group 2 bit-equal to group 1."""
    torch.backends.cuda.matmul.allow_tf32 = False
    kern, plain, args = _window_layout_case(name, cuda, nW=16, heads=16, hd=80)
    got = kern(*args)
    same = torch.equal(kern(*args, group=2), got)
    torch.cuda.synchronize()
    assert same
    assert _within_tol(got, plain(*[a.float() for a in args]))


PEAK = 8.0  # bias scale of the peaked-score cases


def _peaked_case(name, hd, dev):
    """(kernel, plain, bf16 inputs) with the rel-pos bias scaled by PEAK, so
    each row's maximum lies off the diagonal and p is nearly one-hot: K2 and
    K3 at the bench shapes (hd 64, batch 4) or vit_h's (hd 80), K11-K13 on
    32 windows, T5 on the 32 x 32 global grid."""
    geo = dict(C=768, heads=12, grid=32) if hd == 64 else VITH
    if name in ("window_attention_rows_grid", "attention_relpos_rows"):
        kern, plain, args = _bench_case(name, 4, dev, **geo)
        n = len(args)
        return kern, plain, args[:n - 2] + tuple(t * PEAK for t in args[n - 2:])
    if name == "inker_attention":
        gen = torch.Generator(device=dev).manual_seed(30)
        q, k, v = (_rn(gen, dev, 48, 1024, hd) for _ in range(3))
        tables = (_rn(gen, dev, 63, hd, scale=0.1 * PEAK) for _ in range(2))
        rh, rw = fused_block.expand_rel_pos(*tables, 32, torch.bfloat16)
        return (lambda *a: experiment_block_variants.inker_attention(*a, 32, 32),
                lambda *a: experiment_block_variants.inker_attention_plain(*a, 32, 32),
                (q, k, v, rh, rw))
    kern, plain, args = _window_layout_case(name, dev, nW=32, heads=geo["heads"], hd=hd)
    if name == "window_attention_rows":
        return kern, plain, (args[0], args[1] * PEAK, args[2] * PEAK)
    return kern, plain, args[:-2] + tuple(t * PEAK for t in args[-2:])


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("name", ["window_attention_rows_grid", "attention_relpos_rows",
                                  "window_attention_rows", "window_attention_relpos",
                                  "window_attention_relpos_batched", "inker_attention"])
def test_cuda_attention_kernels_match_plain_with_peaked_scores(cuda, name, hd):
    """K2, K3, K11-K13 and T5 global with the bias scaled by 8 (row maxima
    off the diagonal, p nearly one-hot) at head_dim 64 and 80: within 2e-2
    (1 + |plain|) of the plain version in fp32; one launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    kern, plain, args = _peaked_case(name, hd, cuda)
    before = _build.launches[name]
    got = kern(*args)
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 1
    assert _within_tol(got, plain(*[a.float() for a in args]))


def _rn(gen, dev, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [2, 3, 4, 8])
def test_cuda_diag_attn_matches_plain(cuda, g):
    """T1 on 48 windows of 14 x 14 (C 768, 12 heads) folded g to a product
    (g 3: 588 tokens, a ragged last query tile and key tile): within 2e-2
    (1 + |plain|) of its plain version in fp32, and of K11 on the same
    windows; one launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(14)
    qkv = _rn(gen, cuda, 48, 196, 3 * 768)
    bh, bw = (_rn(gen, cuda, 48, 12, 196, 14) for _ in range(2))
    before = _build.launches["diag_attn"]
    got = experiment_group_window.diag_attn(qkv, bh, bw, g)
    torch.cuda.synchronize()
    assert _build.launches["diag_attn"] == before + 1
    f32 = [a.float() for a in (qkv, bh, bw)]
    assert _within_tol(got, experiment_group_window.diag_attn_plain(*f32, g))
    assert _within_tol(got, fused_block.window_attention_rows_plain(*f32, 14, 12))


@pytest.mark.cuda
def test_cuda_window_attn_kernels_match_plain_and_every_group_is_bit_equal(cuda):
    """T2 on 432 (window, head) pairs, q/k 92 wide, v 64: within 2e-2
    (1 + |plain|) of its plain version in fp32; T3 at G 2, 4 and 16
    bit-equal to T2; one launch each."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(15)
    q, k = (_rn(gen, cuda, 432, 196, 92, scale=0.3) for _ in range(2))
    v = _rn(gen, cuda, 432, 196, 64)
    before = (_build.launches["window_attn_kernel1"], _build.launches["window_attn_grouped"])
    got = experiment_window_attn.window_attn_kernel1(q, k, v)
    grouped = [experiment_window_attn.window_attn_grouped(q, k, v, G) for G in (2, 4, 16)]
    torch.cuda.synchronize()
    assert (_build.launches["window_attn_kernel1"],
            _build.launches["window_attn_grouped"]) == (before[0] + 1, before[1] + 3)
    assert all(torch.equal(o, got) for o in grouped)
    assert _within_tol(got, experiment_window_attn.window_attn_plain(q.float(), k.float(),
                                                                     v.float()))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 80])
def test_cuda_sel_attention_matches_plain(cuda, hd):
    """T4 on 432 (window, head) pairs of 196 tokens, pre-scaled q, bias rows
    [432, 196, 14]: within 2e-2 (1 + |plain|) of its plain version in fp32;
    one launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(16)
    q = _rn(gen, cuda, 432, 196, hd, scale=hd ** -0.5)
    k, v = (_rn(gen, cuda, 432, 196, hd) for _ in range(2))
    qh, qw = (_rn(gen, cuda, 432, 196, 14) for _ in range(2))
    before = _build.launches["sel_attention"]
    got = experiment_relpos_kernel.sel_attention(q, k, v, qh, qw)
    torch.cuda.synchronize()
    assert _build.launches["sel_attention"] == before + 1
    assert _within_tol(got, experiment_relpos_kernel.sel_attention_plain(
        *[a.float() for a in (q, k, v, qh, qw)]))


@pytest.mark.cuda
@pytest.mark.parametrize("BH,side,hd", [(432, 14, 64), (48, 32, 64), (32, 32, 80)])
def test_cuda_inker_attention_matches_plain(cuda, BH, side, hd):
    """T5 on a 14 x 14 window (K13's table mode at one head) and on the
    32 x 32 global grid (MODE_TABLE, head_dim 64 and 80), unscaled q, the
    expanded tables [N, side, hd]: within 2e-2 (1 + |plain|) of its plain
    version in fp32; one launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(21)
    N = side * side
    q, k, v = (_rn(gen, cuda, BH, N, hd) for _ in range(3))
    rh, rw = fused_block.expand_rel_pos(_rn(gen, cuda, 2 * side - 1, hd, scale=0.1),
                                        _rn(gen, cuda, 2 * side - 1, hd, scale=0.1), side,
                                        torch.bfloat16)
    before = _build.launches["inker_attention"]
    got = experiment_block_variants.inker_attention(q, k, v, rh, rw, side, side)
    torch.cuda.synchronize()
    assert _build.launches["inker_attention"] == before + 1
    assert _within_tol(got, experiment_block_variants.inker_attention_plain(
        *[a.float() for a in (q, k, v, rh, rw)], side, side))


@pytest.mark.cuda
def test_cuda_gemm_swizzled_unit_product_is_exact(cuda):
    """One block, one K tile of csrc/gemm.cu: x [128, 64] . w^T, w [N, 64]
    (N 128: one m64n128 product a warpgroup; N 256: m64n256), through the
    128-byte-swizzled A and B stages, both written by TMA (flat A_BF16
    rows). Small integers make
    every product and sum exact in fp32, so a wrong swizzle, descriptor or
    accumulator layout shows as an unequal element; then a staircase x
    picks single rows of w, which localises one."""
    gen = torch.Generator(device=cuda).manual_seed(31)
    for n in (128, 256):
        x = torch.randint(-2, 3, (1, 128, 64), generator=gen, device=cuda).to(torch.bfloat16)
        w = torch.randint(-2, 3, (n, 64), generator=gen, device=cuda).to(torch.bfloat16)
        got = probe_mosaic.merge_dense(x, w)
        torch.cuda.synchronize()
        assert torch.equal(got.float(), probe_mosaic.merge_dense_plain(x.float(), w.float()))
        rows, cols = torch.arange(128, device=cuda), torch.arange(128, device=cuda) % 64
        stair = torch.zeros((1, 128, 64), dtype=torch.bfloat16, device=cuda)
        stair[0, rows, cols] = 1  # row i of the product is column i % 64 of w
        got = probe_mosaic.merge_dense(stair, w)
        assert torch.equal(got[0], w[:, cols].t())


@pytest.mark.cuda
def test_cuda_gemm_grid_staircase_is_exact(cuda):
    """K8's proj launch, whose A rows come through map_row from the padded
    grid and reach the swizzled A stage by the producer's register stores:
    a staircase attn_out (token m has a single 1 in column m % C, the pad
    cells 7) against integer wp, with x, bp, w1, b1, b2 zero and LN2 the
    identity, so out is exactly column m % C of wp. A wrong row map or a
    wrong register-store swizzle shows as an unequal element. C 256: four
    K tiles and the 256-wide block tile; 144 tokens: a ragged row tile."""
    gen = torch.Generator(device=cuda).manual_seed(33)
    bf = torch.bfloat16
    B, H, W, Hp, Wp, C = 1, 12, 12, 14, 14, 256
    M, Fh = B * H * W, 4 * C
    cols = torch.arange(M, device=cuda) % C
    a = torch.full((B, Hp, Wp, C), 7.0, dtype=bf, device=cuda)
    a[:, :H, :W] = torch.nn.functional.one_hot(cols, C).to(bf).reshape(B, H, W, C)
    wp = torch.randint(-2, 3, (C, C), generator=gen, device=cuda).to(bf)

    def zeros(*shape):
        return torch.zeros(shape, dtype=bf, device=cuda)

    before = _build.launches["proj_ln_mlp_residual_grid"]
    got = fused_ln.proj_ln_mlp_residual_grid(
        zeros(B, H, W, C), a, wp, zeros(C), torch.ones(C, dtype=bf, device=cuda), zeros(C),
        zeros(Fh, C), zeros(Fh), zeros(C, Fh), zeros(C))
    torch.cuda.synchronize()
    assert _build.launches["proj_ln_mlp_residual_grid"] == before + 1
    assert torch.equal(got.reshape(M, C), wp[:, cols].t())


@pytest.mark.cuda
@pytest.mark.parametrize("name,M,C,F", [
    ("ln_dense", 1000, 768, 384),            # N % 256 != 0: the 128-wide tile; ragged M
    ("ln_dense_bias", 16384, 1280, 3840),    # vit_h's qkv (B 64 at 256 px)
    ("proj_ln_mlp_residual", 2000, 1280, 5120),  # vit_h's tail, ragged M
    ("proj_ln_mlp_residual", 4096, 1024, 4096),  # vit_l's tail
    ("ln_mlp_residual", 700, 256, 640),      # hidden % 256 != 0 and ragged M
])
def test_cuda_gemm_modes_match_plain_at_other_widths(cuda, name, M, C, F):
    """The GEMM template's modes off the bench widths: each within 2e-2
    (1 + |plain|) of its plain version in fp32 on the same bf16 inputs;
    one launch each."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(32)

    def rn(*shape, scale=1.0):
        return _rn(gen, cuda, *shape, scale=scale)

    ln = (1 + rn(C, scale=0.1), rn(C, scale=0.1))
    if name.startswith("ln_dense"):
        kern, plain, key = fused_ln.ln_dense, fused_ln.ln_dense_plain, "ln_dense"
        args = (rn(M, C),) + ln + (rn(F, C, scale=C ** -0.5),
                                   rn(F, scale=0.1) if name == "ln_dense_bias" else None)
    elif name == "proj_ln_mlp_residual":
        kern, plain, key = (fused_ln.proj_ln_mlp_residual, fused_ln.proj_ln_mlp_residual_plain,
                            name)
        args = (rn(M, C), rn(M, C), rn(C, C, scale=C ** -0.5), rn(C, scale=0.1)) + ln + (
            rn(F, C, scale=C ** -0.5), rn(F, scale=0.1), rn(C, F, scale=F ** -0.5),
            rn(C, scale=0.1))
    else:
        kern, plain, key = fused_ln.ln_mlp_residual, fused_ln.ln_mlp_residual_plain, name
        args = (rn(M, C),) + ln + (rn(F, C, scale=C ** -0.5), rn(F, scale=0.1),
                                   rn(C, F, scale=F ** -0.5), rn(C, scale=0.1))
    before = _build.launches[key]
    got = kern(*args)
    torch.cuda.synchronize()
    assert _build.launches[key] == before + 1
    assert _within_tol(got, plain(*[a.float() if a is not None else None for a in args]))


@pytest.mark.cuda
@pytest.mark.parametrize("NP", [196, 200])
def test_cuda_merge_dense_matches_plain(cuda, NP):
    """T6: x [32, NP, 256] . W^T, W [256, 256] ([out, in]) within 2e-2 (1 +
    |plain|) of its plain version in fp32; one launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(22)
    x, w = _rn(gen, cuda, 32, NP, 256), _rn(gen, cuda, 256, 256)
    before = _build.launches["merge_dense"]
    got = probe_mosaic.merge_dense(x, w)
    torch.cuda.synchronize()
    assert _build.launches["merge_dense"] == before + 1
    assert _within_tol(got, probe_mosaic.merge_dense_plain(x.float(), w.float()))


# (B, N): one key, one ragged key tile, one whole, one and a bit, T7's own
# shape, and 16 key tiles (the ring of 4 refilled)
ROWMAX_SIZES = ((1, 1), (3, 17), (2, 64), (5, 65), (32, 200), (4, 1000))


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", [("batched_dot", (B, N, 64)) for B, N in ROWMAX_SIZES]
                         + [("lane_slice", (8, 200, 768)), ("lane_slice", (3, 17, 768))])
def test_cuda_rowmax_dot_probes_match_plain(cuda, name, shape):
    """T7 (q [B, N, 64] at every (B, N) of ROWMAX_SIZES) and T8 (x [B, N,
    768], heads 0 and 1: column offsets 0 and 64, row stride 768) through
    rowmax_dot: within 2e-2 (1 + |plain|) of the plain version in fp32 (on
    the CPU the wrapper takes it); one launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x = _rn(torch.Generator(device=cuda).manual_seed(23), cuda, *shape)
    kern = getattr(probe_mosaic, name)
    before = _build.launches[name]
    got = kern(x)
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 1
    assert got.shape == shape[:2]
    assert _within_tol(got, kern(x.float().cpu()).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(3, 17), (8, 200)])
def test_cuda_rowmax_dot_never_takes_a_zero_filled_key_row(cuda, B, N):
    """T8 on x [B, N, 768] whose head 0 is positive and head 1 negative, so
    every score is below 0 and so is every row max: a key row past N, which
    the kernel zero-fills, would score 0 and win the max unless it is
    masked. Within 2e-2 (1 + |plain|) of the plain version, every output
    negative; one launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(30)
    x = torch.randn((B, N, 768), generator=gen, device=cuda)
    x[..., :64] = 0.5 + torch.rand((B, N, 64), generator=gen, device=cuda)
    x[..., 64:128] = -0.5 - torch.rand((B, N, 64), generator=gen, device=cuda)
    x = x.bfloat16()
    ref = probe_mosaic.lane_slice(x.float().cpu()).to(cuda)
    assert bool((ref < -1).all())
    before = _build.launches["lane_slice"]
    got = probe_mosaic.lane_slice(x)
    torch.cuda.synchronize()
    assert _build.launches["lane_slice"] == before + 1
    assert bool((got < 0).all())
    assert _within_tol(got, ref)


@pytest.mark.cuda
def test_cuda_batched_dot_finds_row_maxima_off_the_diagonal(cuda):
    """T7 at its strides on q [32, 200, 64] whose rows are s_n u_b plus
    noise, with s 3 and -3 at two rows an image that move across the key
    tiles (the last, partial one too): each row's max is at one of them,
    not on the diagonal, so the kernel must visit every key tile to stay
    within 2e-2 (1 + |plain|) of rowmax_dot_plain."""
    gen = torch.Generator(device=cuda).manual_seed(25)
    B, N, D = 32, 200, 64
    s = torch.rand((B, N), generator=gen, device=cuda) * 2 - 1
    b = torch.arange(B, device=cuda)
    s[b, 37 * b % N], s[b, (37 * b + N // 2) % N] = 3.0, -3.0
    u = torch.randn((B, 1, D), generator=gen, device=cuda)
    q = (s[..., None] * u + 0.1 * torch.randn((B, N, D), generator=gen, device=cuda)).bfloat16()
    ref = probe_mosaic.rowmax_dot_plain(q.float(), q.float())
    assert (ref > torch.einsum("bnc,bnc->bn", q.float(), q.float()) + 1).float().mean() > 0.9
    assert _within_tol(probe_mosaic.batched_dot(q), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,C,win", [(32, 32, 256, 14), (23, 13, 100, 5), (3, 7, 64, 8)])
def test_cuda_row_block_affine_probes_are_bit_equal_to_plain(cuda, H, W, C, win):
    """T9 (ceil(H / win) win rows out, the rows past H 1.0) and T10 (2 x into
    exactly H rows) on x [2, H, W, C] fp32 in blocks of win rows, the last
    partial (at 13 x 100 a partial column strip; at 23 and 3 rows an odd
    number out, no multiple of the kernel's row pairs; at H 3 < win 8 one
    block, mostly past H): bit-equal to their plain versions; T10 through a
    view of H rows of a buffer whose rows past H hold NaN leaves them NaN;
    one launch a call."""
    pnb = probe_nondiv_blocks
    x = torch.randn((2, H, W, C), generator=torch.Generator(device=cuda).manual_seed(27),
                    device=cuda)
    names = ("nondiv_read_write", "nondiv_out_exact")
    before = [_build.launches[n] for n in names]
    y9 = pnb.nondiv_read_write(x, win)
    y10 = pnb.nondiv_out_exact(x, win)
    buf = torch.full((2, H + pnb.GUARD_ROWS, W, C), math.nan, device=cuda)
    pnb.nondiv_out_exact(x, win, out=buf[:, :H])
    torch.cuda.synchronize()
    assert [_build.launches[n] - b for n, b in zip(names, before)] == [1, 2]
    assert torch.equal(y9, pnb.row_block_affine_plain(x, -(-H // win) * win, 1.0, 1.0))
    assert bool((y9[:, H:] == 1).all())
    assert torch.equal(y10, pnb.row_block_affine_plain(x, H, 2.0, 0.0))
    assert torch.equal(buf[:, :H], y10) and bool(torch.isnan(buf[:, H:]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,W,C,win", [(2, 14, 32, 256, 14), (2, 5, 23, 100, 5),
                                         (2, 5, 23, 99, 5), (2, 35000, 3, 4, 2)])
def test_cuda_window_colsum_probes_match_plain_and_are_bit_equal(cuda, B, R, W, C, win):
    """T11 (staged, zero-padded) on x [B, R, W, C] fp32 within 1e-4 of
    window_colsum_plain, as the JAX probe allows; T12 (masked global reads)
    bit-equal to T11; at 23 x 100 in windows of 5 the last window column
    and the last channel slice are partial; C 99 (no multiple of 4) takes
    the scalar instance; B R = 70000 rows lie past 65535 on the grid's x;
    one launch each."""
    pnb = probe_nondiv_blocks
    x = torch.randn((B, R, W, C), generator=torch.Generator(device=cuda).manual_seed(28),
                    device=cuda)
    names = ("inkernel_pad_loop", "oversized_sublane_block")
    before = [_build.launches[n] for n in names]
    staged = pnb.inkernel_pad_loop(x, win)
    masked = pnb.oversized_sublane_block(x, win)
    torch.cuda.synchronize()
    assert [_build.launches[n] - b for n, b in zip(names, before)] == [1, 1]
    assert staged.shape == (B, R, -(-W // win), C)
    assert (staged - pnb.window_colsum_plain(x, win)).abs().max().item() <= pnb.SUM_TOL
    assert torch.equal(masked, staged)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,N", [(12, 256), (3, 200), (12, 196), (2, 198), (1, 1),
                                     (64, 256)])
def test_cuda_batched_nt_shapes_are_bit_equal_and_match_plain(cuda, heads, N):
    """T13 on a, b [heads, N, 64] bf16 (N 200: no multiple of 16 or 64; 196
    and 198: 8- and 4-byte output stores; 1: a lone element, 2-byte stores;
    64 heads: 1024 items, so the looped grid's blocks walk several): the
    looped and batched launch shapes bit-equal, within 2e-2 (1 + |plain|)
    of batched_nt_plain in fp32; one launch each; the looped grid min(SMs,
    items) blocks, the batched one a block per item."""
    gen = torch.Generator(device=cuda).manual_seed(29)
    a, b = _rn(gen, cuda, heads, N, 64), _rn(gen, cuda, heads, N, 64)
    before = _build.launches["batched_nt"]
    looped = repro_aot_crash.batched_nt(a, b, looped=True)
    batched = repro_aot_crash.batched_nt(a, b, looped=False)
    torch.cuda.synchronize()
    assert _build.launches["batched_nt"] == before + 2
    assert torch.equal(looped, batched)
    assert _within_tol(looped, repro_aot_crash.batched_nt_plain(a.float(), b.float()))
    items = heads * (-(-N // 64)) ** 2
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert repro_aot_crash.batched_nt_grid(heads, N, True) == min(sms, items)
    assert repro_aot_crash.batched_nt_grid(heads, N, False) == items
