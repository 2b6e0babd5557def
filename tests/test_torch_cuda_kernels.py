"""The port's CUDA kernels against their plain PyTorch versions, in bf16 at
the bench shapes (ViT-B at 512 px: C 768, 12 heads, 32x32 token grid,
window 14), on an NVIDIA GPU.

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
