"""The numerics of K5's fp32 kernel (sam_road_tpu_torch/csrc/
folded_attention_f32.cu), emulated in plain torch on the CPU.

The kernel runs every fp32 product as three TF32 products on the tensor
cores: each operand x splits into hi = rna(x) and lo = rna(x - hi), where
rna rounds to TF32 as cvt.rna.tf32.f32 does (to nearest, ties away from
zero, on the low 13 bits), and a.b ~ lo_a.hi_b + hi_a.lo_b + hi_a.hi_b in
fp32. Here both of its products (q~.k~^T and p.v, p unnormalised, divided
by the row sum at the end, as the kernel does) are emulated on K5's
inputs folded by models/vit.py::fold_rel_pos_qk at its four instances, and
held to an fp64 reference within chip_smoke.py's TOL_F32 = 1e-4 (1 +
|ref|), the tolerance the card holds the kernel to; one TF32 product on
the same inputs misses it, which is why the kernel splits. A TF32 product
of two TF32 values is exact in fp32, so an fp32 matmul of rounded operands
is the tensor core's product up to the order of the fp32 sums.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sam_road_tpu.ops import attention as jattn
from sam_road_tpu_torch.models.vit import fold_rel_pos_qk

TOL_F32 = 1e-4  # chip_smoke.py's tolerance for the fp32 kernel

# (label, B, heads, grid side, head_dim): ViT-B's window (D 92 -> 96), the
# 256 px and 512 px global grids (D 96, 128), vit_h's window (D 108 -> 112)
CASES = [("window 14x14", 2, 2, 14, 64), ("global 16x16", 1, 2, 16, 64),
         ("global 32x32", 1, 1, 32, 64), ("vit_h window 14x14", 2, 2, 14, 80)]


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero: half a TF32 ulp added to the magnitude bits, the low 13
    cleared (cvt.rna.tf32.f32 on finite values)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from three TF32 products in fp32, the small terms first."""
    ah, al = split(a)
    bh, bl = split(b)
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from one TF32 product: what a TF32 tensor core alone gives."""
    return torch.matmul(rna_tf32(a), rna_tf32(b))


def attention(q, k, v, mm):
    """softmax(q.k^T).v in fp32 with every product through `mm`, as the
    kernel orders it: p = exp(s - rowmax) unnormalised into p.v, then the
    division by the row sum."""
    s = mm(q, k.transpose(-1, -2))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return mm(p, v) / p.sum(dim=-1, keepdim=True)


def folded_inputs(B, heads, side, hd, seed=3):
    """fp32 q~, k~ (folded, padded to a multiple of 16) and v from numpy
    normals, as chip_smoke.py::flash_cases draws them."""
    rng = np.random.default_rng(seed)
    N = side * side
    q, k, v = (torch.from_numpy(rng.standard_normal((B, heads, N, hd), dtype=np.float32))
               for _ in range(3))
    Rh, Rw = (torch.from_numpy(rng.standard_normal((side, side, hd), dtype=np.float32)
                               * np.float32(0.3 * hd ** -0.5)) for _ in range(2))
    qa, ka = fold_rel_pos_qk(q, k, Rh, Rw, (side, side), hd ** -0.5)
    return qa.contiguous(), ka.contiguous(), v


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.double() - ref).abs() / (1 + ref.abs())).max().item()


@pytest.mark.parametrize("x,want", [
    (1 + 2.0 ** -11, 1 + 2.0 ** -10),           # a tie rounds away from zero
    (-(1 + 2.0 ** -11), -(1 + 2.0 ** -10)),
    (1 + 2.0 ** -11 - 2.0 ** -23, 1.0),         # below the tie rounds down
    (1 + 3 * 2.0 ** -11, 1 + 2.0 ** -9),        # a tie between two ulps, away
    (2.0 - 2.0 ** -23, 2.0),                    # the carry reaches the exponent
    (0.0, 0.0),
])
def test_rna_tf32_rounds_to_nearest_ties_away(x, want):
    got = rna_tf32(torch.tensor([x], dtype=torch.float32)).item()
    assert got == want


def test_split_halves_are_tf32_and_sum_to_x_within_2_pow_minus_21():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096, dtype=np.float32) * 8)
    hi, lo = split(x)
    for part in (hi, lo):
        assert (part.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((hi.double() + lo.double() - x.double()).abs() <= x.double().abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("label,B,heads,side,hd", CASES)
def test_three_tf32_products_meet_the_fp32_tolerance_and_one_does_not(label, B, heads, side,
                                                                      hd):
    q, k, v = folded_inputs(B, heads, side, hd)
    ref = torch.softmax(q.double() @ k.double().transpose(-1, -2), dim=-1) @ v.double()
    err3 = rel_err(attention(q, k, v, mm_3xtf32), ref)
    err1 = rel_err(attention(q, k, v, mm_1xtf32), ref)
    assert err3 <= TOL_F32, f"{label}: three TF32 products {err3:.3e}"
    assert err1 > TOL_F32, f"{label}: one TF32 product {err1:.3e} within {TOL_F32}"
    # the split lands at plain fp32's own error, far inside the tolerance
    err32 = rel_err(attention(q, k, v, torch.matmul), ref)
    assert err3 <= 10 * max(err32, 1e-7)


def test_three_tf32_products_match_the_jax_kernel_on_a_window():
    """The emulated kernel against sam_road_tpu's fused_attention (Pallas,
    interpret mode) on the JAX package's own fold of the same inputs."""
    from sam_road_tpu.models import vit as jvit

    rng = np.random.default_rng(5)
    side, hd = 14, 64
    q, k, v = (rng.standard_normal((1, 2, side * side, hd), dtype=np.float32) for _ in range(3))
    Rh, Rw = (rng.standard_normal((side, side, hd), dtype=np.float32) * np.float32(0.3 / 8)
              for _ in range(2))
    qa, ka = jvit.fold_rel_pos_qk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(Rh),
                                  jnp.asarray(Rw), (side, side), hd ** -0.5)
    want = np.array(jattn.fused_attention(qa, ka, jnp.asarray(v), True))
    tq, tk = fold_rel_pos_qk(*(torch.from_numpy(a) for a in (q, k, Rh, Rw)), (side, side),
                             hd ** -0.5)
    got = attention(tq, tk, torch.from_numpy(v), mm_3xtf32)
    assert rel_err(got, torch.from_numpy(want).double()) <= TOL_F32
