"""K1 ln_dense and K4 proj_ln_mlp_residual: the encoder's per-token chains
(counterparts of sam_road_tpu/ops/fused_ln.py), and their window-grid modes
K7 ln_dense_padded and K8 proj_ln_mlp_residual_grid (the PAD_FREE path).

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

K7 replaces fused_ln.py::ln_dense_padded and K8 fused_ln.py::
proj_ln_mlp_residual_grid. Both are modes of the same GEMM template that
change only where a token's row lives: K7 writes token (b, y, x) at its
row of the window-padded grid [B, Hp, Wp, F] and a small kernel zeroes the
pad positions (and no others), so the F.pad pass over the padded qkv
(about 260 MB of writes at the bench geometry) goes; K8's first launch reads
the attention output at its padded-grid row, so the crop copy goes. On the
real tokens each is bit-equal to K1 and K4: the K loop, the accumulation
order and the epilogues are unchanged. Bound like K1 and K4 by tensor-core
rate.

K6 (the training path, FUSED_ENCODER_TRAIN): ln_dense_d, ln_dense_bias_d
and proj_ln_mlp_residual_d are autograd.Functions that replace the JAX
custom_vjp wrappers of the same names (fused_ln.py:326-399). The forward
launches K1 or K4 and saves exactly the primal inputs, the residuals JAX
saves; the backward recomputes the plain version under autograd on them
(_build.recompute_vjp), as JAX's backward is jax.vjp of the XLA reference,
and launches no custom kernel. On a CUDA tensor the forward counts once
under the kernel's name and once under the wrapper's.
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


def ln_dense_padded_plain(x, ln_scale, ln_bias, w, pad_hw):
    """ln_dense_plain (bias-free) over x [B, H, W, C], then zero-padded to
    [B, H + pad_h, W + pad_w, F]."""
    B, H, W, C = x.shape
    out = ln_dense_plain(x.reshape(B * H * W, C), ln_scale, ln_bias, w)
    return F.pad(out.reshape(B, H, W, -1), (0, 0, 0, pad_hw[1], 0, pad_hw[0]))


def ln_dense_padded(x, ln_scale, ln_bias, w, pad_hw):
    """K7: LayerNorm then bias-free dense, written straight into the
    window-padded grid: x [B, H, W, C] -> [B, H + pad_h, W + pad_w, F] with
    exact zeros at the pad positions."""
    if _build.on_cpu(x):
        return ln_dense_padded_plain(x, ln_scale, ln_bias, w, pad_hw)
    B, H, W, C = x.shape
    Hp, Wp = H + int(pad_hw[0]), W + int(pad_hw[1])
    Fo = w.shape[0]
    bf = torch.bfloat16
    _build.require(x, "x", bf)
    _build.require(ln_scale, "ln_scale", bf, (C,))
    _build.require(ln_bias, "ln_bias", bf, (C,))
    _build.require(w, "w", bf, (Fo, C))
    if Fo % 128 or C % 32 or Hp < H or Wp < W:
        raise ValueError(f"ln_dense_padded kernel needs F % 128 == 0, C % 32 == 0 and "
                         f"non-negative pads, got F={Fo} C={C} pad={tuple(pad_hw)}")
    out = torch.empty((B, Hp, Wp, Fo), dtype=bf, device=x.device)
    _build.check(_build.kernels().samroad_ln_dense_padded(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w.data_ptr(), out.data_ptr(),
        B, H, W, Hp, Wp, Fo, C, _build.stream_of(x)), "ln_dense_padded")
    _build.launches["ln_dense_padded"] += 1
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


def proj_ln_mlp_residual_grid_plain(x, attn_out_padded, wp, bp, ln_scale, ln_bias, w1, b1,
                                    w2, b2):
    """proj_ln_mlp_residual_plain over x [B, H, W, C] with the attention
    output cropped from its padded grid [B, Hp, Wp, C]."""
    B, H, W, C = x.shape
    a = attn_out_padded[:, :H, :W, :].reshape(B * H * W, C)
    return proj_ln_mlp_residual_plain(x.reshape(B * H * W, C), a, wp, bp, ln_scale, ln_bias,
                                      w1, b1, w2, b2).reshape(B, H, W, C)


def proj_ln_mlp_residual_grid(x, attn_out_padded, wp, bp, ln_scale, ln_bias, w1, b1, w2, b2):
    """K8: K4 over x [B, H, W, C] reading the attention output from the
    window-padded grid [B, Hp, Wp, C] it was written on; returns
    [B, H, W, C]."""
    if _build.on_cpu(x):
        return proj_ln_mlp_residual_grid_plain(x, attn_out_padded, wp, bp, ln_scale, ln_bias,
                                               w1, b1, w2, b2)
    B, H, W, C = x.shape
    _, Hp, Wp, _ = attn_out_padded.shape
    Fh = w1.shape[0]
    bf = torch.bfloat16
    _build.require(x, "x", bf)
    _build.require(attn_out_padded, "attn_out_padded", bf)
    if attn_out_padded.shape[0] != B or attn_out_padded.shape[3] != C or Hp < H or Wp < W:
        raise ValueError(f"attn_out_padded {tuple(attn_out_padded.shape)} is not a padded grid "
                         f"of x {tuple(x.shape)}")
    for t, name, shape in ((wp, "wp", (C, C)), (bp, "bp", (C,)), (ln_scale, "ln_scale", (C,)),
                           (ln_bias, "ln_bias", (C,)), (w1, "w1", (Fh, C)), (b1, "b1", (Fh,)),
                           (w2, "w2", (C, Fh)), (b2, "b2", (C,))):
        _build.require(t, name, bf, shape)
    if C % 128 or Fh % 128:
        raise ValueError(f"proj_ln_mlp_residual_grid kernel needs C and hidden % 128 == 0, "
                         f"got {C}, {Fh}")
    M = B * H * W
    x1 = torch.empty((M, C), dtype=torch.float32, device=x.device)
    mid = torch.empty((M, Fh), dtype=bf, device=x.device)
    out = torch.empty((B, H, W, C), dtype=bf, device=x.device)
    _build.check(_build.kernels().samroad_proj_ln_mlp_residual_grid(
        x.data_ptr(), attn_out_padded.data_ptr(), wp.data_ptr(), bp.data_ptr(),
        ln_scale.data_ptr(), ln_bias.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), x1.data_ptr(), mid.data_ptr(), out.data_ptr(), B, H, W, Hp, Wp, C, Fh,
        _build.stream_of(x)), "proj_ln_mlp_residual_grid")
    _build.launches["proj_ln_mlp_residual_grid"] += 1
    return out


class _LnDenseD(torch.autograd.Function):
    """K6 ln_dense_d / ln_dense_bias_d: K1 forward, saving the primal
    inputs; backward = autograd of ln_dense_plain recomputed on them."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w, bias):
        ctx.save_for_backward(x, ln_scale, ln_bias, w, bias)
        out = ln_dense(x, ln_scale, ln_bias, w, bias)
        if not _build.on_cpu(x):
            _build.launches["ln_dense_d" if bias is None else "ln_dense_bias_d"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        return _build.recompute_vjp(ctx, ln_dense_plain, g)


def ln_dense_d(x, ln_scale, ln_bias, w):
    """K6: differentiable ln_dense without output bias (the windowed qkv)."""
    return _LnDenseD.apply(x, ln_scale, ln_bias, w, None)


def ln_dense_bias_d(x, ln_scale, ln_bias, w, bias):
    """K6: differentiable ln_dense with output bias (the global qkv)."""
    return _LnDenseD.apply(x, ln_scale, ln_bias, w, bias)


class _ProjLnMlpResidualD(torch.autograd.Function):
    """K6 proj_ln_mlp_residual_d: K4 forward, saving the primal inputs;
    backward = autograd of proj_ln_mlp_residual_plain recomputed on them."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        out = proj_ln_mlp_residual(*args)
        if not _build.on_cpu(args[0]):
            _build.launches["proj_ln_mlp_residual_d"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        return _build.recompute_vjp(ctx, proj_ln_mlp_residual_plain, g)


def proj_ln_mlp_residual_d(x, attn_out, wp, bp, ln_scale, ln_bias, w1, b1, w2, b2):
    """K6: differentiable proj_ln_mlp_residual (the whole block tail)."""
    return _ProjLnMlpResidualD.apply(x, attn_out, wp, bp, ln_scale, ln_bias, w1, b1, w2, b2)
