"""The port's CUDA kernels against their plain PyTorch versions, in bf16 at
the bench shapes (ViT-B at 512 px: C 768, 12 heads, 32x32 token grid,
window 14), the K6 wrappers' forward and gradients at the training shapes
(the same at batch 16), and the grid modes K7, K8 and K10 bit-equal to the
kernels they vary (K1 + pad, K4 on the cropped input, K2), on an NVIDIA GPU.

The kernels have no CPU mode, so every test here is marked `cuda` and skips
where torch sees no GPU. This file imports neither jax nor the JAX package,
so it also runs on the card's machine:
    python -m pytest tests/test_torch_cuda_kernels.py -q
"""

import pytest
import torch

from sam_road_tpu_torch.ops import _build, attention, fused_block, fused_ln


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bench_case(name, B, dev):
    """Inputs at the bench shapes (ViT-B, 512 px: C 768, 12 heads, 32x32
    grid, window 14) for one kernel, bf16."""
    gen = torch.Generator(device=dev).manual_seed(7)
    bf = torch.bfloat16

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    C, heads, hd, grid, win = 768, 12, 64, 32, 14
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
        gp, nw = 42, 3
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


@pytest.mark.cuda
@pytest.mark.parametrize("B,side", [(36, 14), (4, 32), (1, 64)])
def test_cuda_fused_attention_forward_and_backward(cuda, B, side):
    """K5 at the ViT-B window (196 tokens, D 92), 512 px global (1024, D 128)
    and 1024 px global (4096, D 192) shapes, bf16: the forward and the
    autograd.Function's gradients within 2e-2 (1 + |ref|) of the plain
    version under autograd in fp32 on the same inputs."""
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(8)
    heads, hd, N = 12, 64, side * side

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=cuda) * scale

    idx = torch.arange(N, device=cuda)
    pos = torch.cat([F.one_hot(idx // side, side), F.one_hot(idx % side, side)], 1).float()
    q = torch.cat([rn(B, heads, N, hd, scale=hd ** -0.5), rn(B, heads, N, 2 * side, scale=0.3)],
                  -1).to(torch.bfloat16)
    k = torch.cat([rn(B, heads, N, hd), pos.expand(B, heads, N, 2 * side)], -1).to(torch.bfloat16)
    v, g = (rn(B, heads, N, hd).to(torch.bfloat16) for _ in range(2))
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
