"""K2 window_attention_rows_grid: windowed attention on the padded token
grid (counterpart of sam_road_tpu/ops/fused_block.py).

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
hand-written kernel in csrc/window_attention.cu or raises.

Source note. Replaces fused_block.py::window_attention_rows_grid at its
default granularity (_window_attn_rows_grid_kernel + _win_attn_body). On the
H100 a window's attention is small (9.8 MFLOP per (window, head)), so the
kernel is bound by latency and shared-memory traffic: one block per (image,
window, head) reads q/k/v with strides straight from the bias-free grid,
adds the qkv bias to every token (pad tokens become exactly `bias`), pads
the 196 tokens to 208 rows with -inf pad keys, keeps each 16-query score
strip in shared memory, normalises after p.v, and writes the output back in
grid layout, so no window partition or unpartition pass touches HBM.

K10: rolled_rows / group_batch select the granularities of the same JAX
function (_window_attn_rows_grid_rolled_kernel, _window_attn_rows_grid_
gbatch_kernel). In CUDA they are choices of how blocks map to work over the
same per-window device code: one block per (image, window row, head)
looping over the row's windows, or per (group of G images, window, head)
looping over the group, so their outputs are bit-equal to K2's. G follows
the JAX rule (halved until it divides B) and group_batch > 1 wins over
rolled_rows. Each mode counts its launches under its own name
(window_attention_rows_grid_rolled, window_attention_rows_grid_gbatch).

K6: window_attention_rows_grid_d is an autograd.Function that replaces the
JAX custom_vjp wrapper of that name (fused_block.py:444-467): K2 forward,
the primal inputs saved, and a backward that recomputes the plain version
under autograd (_build.recompute_vjp) and launches no custom kernel. On a
CUDA tensor the forward counts under the kernel's name and the wrapper's.
"""

from __future__ import annotations

import torch

from sam_road_tpu_torch.ops import _build


def window_attention_rows_grid_plain(qkv_grid, qkv_bias, bh, bw, win: int,
                                     num_heads: int):
    """Follows sam_road_tpu/ops/fused_block.py::_window_attn_grid_ref:
    window partition, s = q.k^T * scale + bh[n, i'] + bw[n, j'], fp32
    softmax, p cast to the input dtype for p.v; returns [B, Hp, Wp, C]."""
    B, Hp, Wp, C3 = qkv_grid.shape
    C = C3 // 3
    hd = C // num_heads
    nI, nJ = Hp // win, Wp // win
    N = win * win
    dt = qkv_grid.dtype
    qkv = qkv_grid.reshape(B, nI, win, nJ, win, C3).permute(0, 1, 3, 2, 4, 5)
    qkv = qkv.reshape(B, nI, nJ, N, C3) + qkv_bias.to(dt)

    def heads(t):  # (B, nI, nJ, N, C) -> (B, nI, nJ, num_heads, N, hd)
        return t.reshape(B, nI, nJ, N, num_heads, hd).permute(0, 1, 2, 4, 3, 5)

    q, k, v = heads(qkv[..., :C]), heads(qkv[..., C:2 * C]), heads(qkv[..., 2 * C:])
    s = torch.matmul(q * hd ** -0.5, k.transpose(-1, -2)).float()
    s = s.reshape(B, nI, nJ, num_heads, N, win, win)
    s = s + bh.float()[..., None] + bw.float()[..., None, :]
    p = torch.softmax(s.reshape(B, nI, nJ, num_heads, N, N), dim=-1)
    out = torch.matmul(p.to(dt), v).to(dt)
    out = out.permute(0, 1, 2, 4, 3, 5).reshape(B, nI, nJ, win, win, C)
    return out.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)


MODE_WINDOW, MODE_ROLLED, MODE_GBATCH = 0, 1, 2  # csrc/window_attention.cu's modes


def group_size(group_batch: int, B: int) -> int:
    """The images per block of the group_batch mode: group_batch halved
    until it divides B (sam_road_tpu/ops/fused_block.py's rule)."""
    G = int(group_batch)
    while G > 1 and B % G:
        G //= 2
    return max(G, 1)


def window_attention_rows_grid(qkv_grid, qkv_bias, bh, bw, win: int,
                               num_heads: int, rolled_rows: bool = False,
                               group_batch: int = 1):
    """K2 (K10 with rolled_rows or group_batch > 1). qkv_grid [B, Hp, Wp,
    3C] bias-free on the zero-padded grid, qkv_bias [3C], bh/bw [B, Hp/win,
    Wp/win, heads, win*win, win] bias rows in token order n = i*win + j.
    Returns [B, Hp, Wp, C]; every mode computes the same function."""
    if _build.on_cpu(qkv_grid):
        return window_attention_rows_grid_plain(qkv_grid, qkv_bias, bh, bw,
                                                win, num_heads)
    B, Hp, Wp, C3 = qkv_grid.shape
    G = group_size(group_batch, B)
    if G > 1:
        mode, name = MODE_GBATCH, "window_attention_rows_grid_gbatch"
    elif rolled_rows:
        mode, name = MODE_ROLLED, "window_attention_rows_grid_rolled"
    else:
        mode, name = MODE_WINDOW, "window_attention_rows_grid"
    C = C3 // 3
    if Hp % win or Wp % win:
        raise ValueError(f"grid {Hp}x{Wp} is not a multiple of window {win}")
    if C != 64 * num_heads:
        raise ValueError(f"window attention kernel needs head_dim 64, got {C // num_heads}")
    bf = torch.bfloat16
    rows = (B, Hp // win, Wp // win, num_heads, win * win, win)
    _build.require(qkv_grid, "qkv_grid", bf)
    _build.require(qkv_bias, "qkv_bias", bf, (C3,))
    _build.require(bh, "bh", bf, rows)
    _build.require(bw, "bw", bf, rows)
    out = torch.empty((B, Hp, Wp, C), dtype=bf, device=qkv_grid.device)
    lib = _build.kernels()
    _build.check(lib.samroad_window_attention(
        qkv_grid.data_ptr(), qkv_bias.data_ptr(), bh.data_ptr(), bw.data_ptr(),
        out.data_ptr(), B, Hp, Wp, C, num_heads, win, mode, G,
        _build.stream_of(qkv_grid)), name)
    _build.launches[name] += 1
    return out


class _WindowAttentionRowsGridD(torch.autograd.Function):
    """K6 window_attention_rows_grid_d: K2 forward, saving (qkv_grid,
    qkv_bias, bh, bw); backward = autograd of
    window_attention_rows_grid_plain recomputed on them."""

    @staticmethod
    def forward(ctx, qkv_grid, qkv_bias, bh, bw, win, num_heads):
        ctx.save_for_backward(qkv_grid, qkv_bias, bh, bw)
        ctx.static = (win, num_heads)
        out = window_attention_rows_grid(qkv_grid, qkv_bias, bh, bw, win, num_heads)
        if not _build.on_cpu(qkv_grid):
            _build.launches["window_attention_rows_grid_d"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        return _build.recompute_vjp(ctx, window_attention_rows_grid_plain, g,
                                    *ctx.static) + (None, None)


def window_attention_rows_grid_d(qkv_grid, qkv_bias, bh, bw, win: int, num_heads: int):
    """K6: differentiable window_attention_rows_grid (the windowed blocks
    of the training encoder)."""
    return _WindowAttentionRowsGridD.apply(qkv_grid, qkv_bias, bh, bw, win, num_heads)
