"""K1 ln_dense and K4 proj_ln_mlp_residual: the encoder's per-token chains
(counterparts of sam_road_tpu/ops/fused_ln.py).

Each public function dispatches on its input's device: a CPU tensor takes
the plain PyTorch version (`*_plain`), a CUDA tensor launches the
hand-written kernel in csrc/gemm.cu or raises. Weights use the nn.Linear
layout [out, in]; activations are token-major [M, C] as in the JAX package.

Source note. K1 replaces fused_ln.py::ln_dense (_ln_dense_kernel) and K4
replaces fused_ln.py::proj_ln_mlp_residual (_proj_ln_mlp_kernel). Both are
bound on the H100 by tensor-core rate (LN1+qkv is 116 GFLOP per call at the
bench geometry). The TPU kernels keep their weights resident in VMEM and K4
keeps x1 and the 4C hidden out of HBM; an SM's 227 KB of shared memory
cannot hold W1 and W2 (4.7 MB each), so K4 runs as three GEMM launches of
one kernel template: x1 = x + a.Wp + bp stored in fp32 (the reference keeps
x1 in fp32 through LN2 and the last residual), mid = GELU(LN2(x1).W1 + b1)
in bf16 with LN2 as the GEMM's prologue, out = x1 + b2 + mid.W2. GELU uses
CUDA's exact erff, where the Pallas kernel uses Abramowitz-Stegun
(|err| <= 1.5e-7).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sam_road_tpu_torch.ops import _build

LN_EPS = 1e-6


def layer_norm_f32(x, scale, bias, dt):
    """LayerNorm with fp32 statistics; scale/bias rounded to `dt` first, as
    the Pallas kernels receive them."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    h = (xf - mu) * torch.rsqrt(var + LN_EPS)
    return h * scale.to(dt).float() + bias.to(dt).float()


def ln_dense_plain(x, ln_scale, ln_bias, w, bias=None):
    """y = LN(x) . w^T (+ bias): x [M, C], w [F, C] -> [M, F] in x.dtype.
    Follows sam_road_tpu/ops/fused_ln.py::_ln_dense_ref."""
    dt = x.dtype
    h = layer_norm_f32(x, ln_scale, ln_bias, dt).to(dt)
    out = F.linear(h, w.to(dt)).float()
    if bias is not None:
        out = out + bias.to(dt).float()
    return out.to(dt)


def ln_dense(x, ln_scale, ln_bias, w, bias=None):
    """K1: LayerNorm (eps 1e-6, fp32 statistics) then dense, [M, C] ->
    [M, F]. bias=None skips the output bias (the windowed blocks' qkv, whose
    bias the attention kernel adds after window padding)."""
    if _build.on_cpu(x):
        return ln_dense_plain(x, ln_scale, ln_bias, w, bias)
    M, C = x.shape
    Fo = w.shape[0]
    bf = torch.bfloat16
    _build.require(x, "x", bf)
    _build.require(ln_scale, "ln_scale", bf, (C,))
    _build.require(ln_bias, "ln_bias", bf, (C,))
    _build.require(w, "w", bf, (Fo, C))
    if bias is not None:
        _build.require(bias, "bias", bf, (Fo,))
    if Fo % 128 or C % 32:
        raise ValueError(f"ln_dense kernel needs F % 128 == 0 and C % 32 == 0, got F={Fo} C={C}")
    out = torch.empty((M, Fo), dtype=bf, device=x.device)
    lib = _build.kernels()
    _build.check(lib.samroad_ln_dense(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        M, Fo, C, _build.stream_of(x)), "ln_dense")
    _build.launches["ln_dense"] += 1
    return out


def proj_ln_mlp_residual_plain(x, attn_out, wp, bp, ln_scale, ln_bias, w1, b1,
                               w2, b2):
    """out = x1 + b2 + GELU(LN2(x1) . w1^T + b1) . w2^T with
    x1 = x + attn_out . wp^T + bp in fp32. Follows
    sam_road_tpu/ops/fused_ln.py::_proj_tail_ref."""
    dt = x.dtype
    x1 = (x.float() + F.linear(attn_out.to(dt), wp.to(dt)).float()
          + bp.to(dt).float())
    h = layer_norm_f32(x1, ln_scale, ln_bias, dt).to(dt)
    mid = F.gelu(F.linear(h, w1.to(dt)).float() + b1.to(dt).float())
    out = x1 + b2.to(dt).float() + F.linear(mid.to(dt), w2.to(dt)).float()
    return out.to(dt)


def proj_ln_mlp_residual(x, attn_out, wp, bp, ln_scale, ln_bias, w1, b1, w2,
                         b2):
    """K4: the block tail (proj + residual + LN2 + MLP + residual), [M, C]."""
    if _build.on_cpu(x):
        return proj_ln_mlp_residual_plain(x, attn_out, wp, bp, ln_scale,
                                          ln_bias, w1, b1, w2, b2)
    M, C = x.shape
    Fh = w1.shape[0]
    bf = torch.bfloat16
    _build.require(x, "x", bf)
    _build.require(attn_out, "attn_out", bf, (M, C))
    _build.require(wp, "wp", bf, (C, C))
    _build.require(bp, "bp", bf, (C,))
    _build.require(ln_scale, "ln_scale", bf, (C,))
    _build.require(ln_bias, "ln_bias", bf, (C,))
    _build.require(w1, "w1", bf, (Fh, C))
    _build.require(b1, "b1", bf, (Fh,))
    _build.require(w2, "w2", bf, (C, Fh))
    _build.require(b2, "b2", bf, (C,))
    if C % 128 or Fh % 128:
        raise ValueError(f"proj_ln_mlp_residual kernel needs C and hidden % 128 == 0, got {C}, {Fh}")
    x1 = torch.empty((M, C), dtype=torch.float32, device=x.device)
    mid = torch.empty((M, Fh), dtype=bf, device=x.device)
    out = torch.empty((M, C), dtype=bf, device=x.device)
    lib = _build.kernels()
    _build.check(lib.samroad_proj_ln_mlp_residual(
        x.data_ptr(), attn_out.data_ptr(), wp.data_ptr(), bp.data_ptr(),
        ln_scale.data_ptr(), ln_bias.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), x1.data_ptr(), mid.data_ptr(),
        out.data_ptr(), M, C, Fh, _build.stream_of(x)), "proj_ln_mlp_residual")
    _build.launches["proj_ln_mlp_residual"] += 1
    return out
