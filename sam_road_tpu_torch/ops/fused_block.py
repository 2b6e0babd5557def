"""K2 window_attention_rows_grid: windowed attention on the padded token
grid, and K11-K13, the same attention on materialised windows
(counterparts of sam_road_tpu/ops/fused_block.py).

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
hand-written kernel in csrc/window_attention.cu or raises.

Source note. Replaces fused_block.py::window_attention_rows_grid at its
default granularity (_window_attn_rows_grid_kernel + _win_attn_body). On the
H100 a window's attention is bound by bytes (385 MB, 0.115 ms, against 34
GFLOP at the bench shape), so the work is in latency and shared-memory
traffic. One block per (image, window, head) reads q/k/v with strides
straight from the bias-free grid (cp.async into shared memory for k and v,
q straight into mma fragments), adds the qkv bias to every token (pad tokens
become exactly `bias`), pads the 196 tokens to 208 rows with -inf pad keys
and keeps each warp's 16-query strip register-resident: its 208 scores
(mma.sync.m16n8k16, bf16 in, fp32 out), the masked softmax (two shuffles a
row reduction, exp2) and p, which feeds p.v from registers; the output is
divided after p.v and written back in grid layout from registers, so no
window partition or unpartition pass touches HBM. No score strip in shared
memory: a block takes 70 KB at head_dim 64 (80 KB at 80), and two or three
blocks of 4 warps stay resident an SM.

K10: rolled_rows / group_batch select the granularities of the same JAX
function (_window_attn_rows_grid_rolled_kernel, _window_attn_rows_grid_
gbatch_kernel). In CUDA they are choices of how blocks map to work over the
same per-window device code: one block per (image, window row, head)
looping over the row's windows, or per (group of G images, window, head)
looping over the group, so their outputs are bit-equal to K2's; a looping
block keeps one shared-memory stage and loads the next window once the
current one's products are done, so two or three blocks stay resident an
SM and hide each other's loads. G follows
the JAX rule (halved until it divides B) and group_batch > 1 wins over
rolled_rows. Each mode counts its launches under its own name
(window_attention_rows_grid_rolled, window_attention_rows_grid_gbatch).

K6: window_attention_rows_grid_d is an autograd.Function that replaces the
JAX custom_vjp wrapper of that name (fused_block.py:444-467): K2 forward,
the primal inputs saved, and a backward that recomputes the plain version
under autograd (_build.recompute_vjp) and launches no custom kernel. On a
CUDA tensor the forward counts under the kernel's name and the wrapper's.

K11 window_attention_rows, K12 window_attention_relpos and K13
window_attention_relpos_batched replace the fused_block.py functions of
those names (the tools' and tests' kernels). They are modes of K2's
per-window device code, not copies of it: the tokens come from the window
layout [nW, N, 3C] with the qkv bias already in (K13: head-split q, k, v
[nW, H, N, hd]); K11 reads bias rows [nW, H, N, win], K12 and K13 build them
in the kernel, in fp32, from the expanded tables [N, win, hd]; and all three
normalise p before p.v, where K2 divides after it, so K11 equals K2 only
within bf16 rounding. `group` (windows a block) follows the JAX halving rule
over nW and gives bit-equal outputs. K13's TPU padding of the tokens to a
multiple of 128 with -1e30 keys adds exact zeros; its plain version keeps
it, the kernel computes on the real keys. Like K2, bound by bytes, and
worked by latency and shared-memory traffic; K12 and K13 also read 702 KB
of the expanded tables from L2 for each (window, head).

Head dims: every kernel here has instances at head_dim 64 (ViT-B, vit_l)
and 80 (vit_h); another head_dim raises, as does a window larger than SAM's
14 x 14 (the kernel's score strip holds 208 keys). The kernels scale the fp32 scores
after the product, the JAX body's non-merged branch (fused_block.py:209-214),
which at a power of two equals its merged branch's pre-scaled q bit for bit;
K2's plain version follows whichever branch the JAX body takes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sam_road_tpu_torch.ops import _build


def window_attention_rows_grid_plain(qkv_grid, qkv_bias, bh, bw, win: int,
                                     num_heads: int):
    """Follows sam_road_tpu/ops/fused_block.py::_window_attn_grid_ref:
    window partition, s = q.k^T * scale + bh[n, i'] + bw[n, j'], fp32
    softmax, p cast to the input dtype for p.v; returns [B, Hp, Wp, C].
    The scale goes on q when head_dim is a power of two (exact in any
    dtype: _win_attn_body's merged branch), else on the fp32 product."""
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
    if hd & (hd - 1) == 0:
        s = torch.matmul(q * hd ** -0.5, k.transpose(-1, -2)).float()
    else:
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
    s = s.reshape(B, nI, nJ, num_heads, N, win, win)
    s = s + bh.float()[..., None] + bw.float()[..., None, :]
    p = torch.softmax(s.reshape(B, nI, nJ, num_heads, N, N), dim=-1)
    out = torch.matmul(p.to(dt), v).to(dt)
    out = out.permute(0, 1, 2, 4, 3, 5).reshape(B, nI, nJ, win, win, C)
    return out.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)


MODE_WINDOW, MODE_ROLLED, MODE_GBATCH = 0, 1, 2  # csrc/window_attention.cu's modes


def group_size(group: int, n: int) -> int:
    """Images (K10's group_batch) or windows (K11-K13's group) a block:
    `group` halved until it divides n (sam_road_tpu/ops/fused_block.py's
    rule)."""
    G = int(group)
    while G > 1 and n % G:
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
    if C % num_heads:
        raise ValueError(f"{C} channels do not split into {num_heads} heads")
    _build.require_head_dim(C // num_heads, name)
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


def _split_heads(qkv_windows, num_heads: int):
    """[nW, N, 3C] -> q, k, v [nW, heads, N, hd] (views)."""
    nW, N, C3 = qkv_windows.shape
    return qkv_windows.reshape(nW, N, 3, num_heads, C3 // 3 // num_heads).permute(2, 0, 3, 1, 4)


def _merge_heads(out):
    """[nW, heads, N, hd] -> [nW, N, heads * hd]."""
    nW, H, N, hd = out.shape
    return out.permute(0, 2, 1, 3).reshape(nW, N, H * hd)


def _attend_normalised(q, k, v, bh, bw, win: int):
    """K11-K13's math on q, k, v [..., N, hd] and fp32 bias rows bh, bw
    [..., N, win]: s = q.k^T (fp32) * scale + bh[n, i'] + bw[n, j'] for key
    n' = (i', j'), p = softmax(s) normalised before it is rounded to q.dtype,
    then p.v in fp32 (fused_block.py::_window_attn_rows_kernel)."""
    hd = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
    s = s.unflatten(-1, (win, win)) + bh[..., :, None] + bw[..., None, :]
    p = torch.softmax(s.flatten(-2), dim=-1)
    return torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype)


def expand_rel_pos(rel_pos_h, rel_pos_w, win: int, dt):
    """The tables the K12 / K13 kernels read, built as fused_block.py:591-595
    builds them: rh[(i, j), a] = rel_pos_h[i - a + win - 1], rw[(i, j), a] =
    rel_pos_w[j - a + win - 1], each [win * win, win, hd] in dt."""
    idx = torch.arange(win, device=rel_pos_h.device)
    coords = idx[:, None] - idx[None, :] + win - 1
    rh = rel_pos_h[coords].repeat_interleave(win, dim=0)  # row (i, j) -> Rh[i]
    rw = rel_pos_w[coords].repeat(win, 1, 1)              # row (i, j) -> Rw[j]
    return rh.to(dt).contiguous(), rw.to(dt).contiguous()


def _table_rows(q, rh, rw):
    """bh[.., n, a] = sum_c q[.., n, c] rh[n, a, c] in fp32 (never rounded),
    and bw from rw: the bias rows K12 and K13 build in the kernel."""
    qf = q.float()
    return (torch.einsum("...nc,nac->...na", qf, rh.float()),
            torch.einsum("...nc,nac->...na", qf, rw.float()))


def window_attention_rows_plain(qkv_windows, bh, bw, win: int, num_heads: int):
    """Follows fused_block.py::_window_attn_rows_kernel: qkv_windows [nW, N,
    3C] (bias in), bias rows bh, bw [nW, heads, N, win] rounded to the input
    dtype; returns [nW, N, C]."""
    dt = qkv_windows.dtype
    q, k, v = _split_heads(qkv_windows, num_heads)
    return _merge_heads(_attend_normalised(q, k, v, bh.to(dt).float(), bw.to(dt).float(), win))


def window_attention_relpos_plain(qkv_windows, rel_pos_h, rel_pos_w, win: int,
                                  num_heads: int):
    """Follows fused_block.py::_window_attn_kernel: K11 with the bias rows
    built in fp32 from the expanded tables (rounded to the input dtype);
    rel_pos_h / rel_pos_w (2 win - 1, hd); returns [nW, N, C]."""
    rh, rw = expand_rel_pos(rel_pos_h, rel_pos_w, win, qkv_windows.dtype)
    q, k, v = _split_heads(qkv_windows, num_heads)
    return _merge_heads(_attend_normalised(q, k, v, *_table_rows(q, rh, rw), win))


def window_attention_relpos_batched_plain(q, k, v, rel_pos_h, rel_pos_w, win: int):
    """Follows fused_block.py::_window_attn_batched_kernel, its padding
    included: (window, head) pairs as one batch, the N tokens zero-padded to
    Np (a multiple of 128), the bias spread by selectors that skip the pad
    keys, -1e30 added to the pad keys' scores; q, k, v [nW, heads, N, hd] ->
    [nW, heads, N, hd]."""
    nW, H, N, hd = q.shape
    dt = q.dtype
    Np = -(-max(N, 128) // 128) * 128
    rh, rw = expand_rel_pos(rel_pos_h, rel_pos_w, win, dt)
    rh, rw = (F.pad(t, (0, 0, 0, 0, 0, Np - N)) for t in (rh, rw))
    qf, kf, vf = (F.pad(t.reshape(nW * H, N, hd), (0, 0, 0, Np - N)).float() for t in (q, k, v))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * hd ** -0.5
    bh, bw = _table_rows(qf, rh, rw)
    key = torch.arange(Np, device=q.device)
    a = torch.arange(win, device=q.device)[:, None]
    real = key < N
    s = s + bh @ ((key // win == a) & real).float() + bw @ ((key % win == a) & real).float()
    s = s + torch.where(real, 0.0, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p.to(dt).float(), vf).to(dt)
    return out[:, :N].reshape(nW, H, N, hd)


def _kernel_tables(rel_pos_h, rel_pos_w, win: int, hd: int):
    """The expanded bf16 tables the K12 / K13 kernels read, checked."""
    rh, rw = expand_rel_pos(rel_pos_h, rel_pos_w, win, torch.bfloat16)
    for t, name in ((rh, "rel_pos_h"), (rw, "rel_pos_w")):
        _build.require(t, name, torch.bfloat16, (win * win, win, hd))
    return rh, rw


def _check_window(N: int, C: int, win: int, num_heads: int, name: str) -> None:
    if N != win * win:
        raise ValueError(f"{name}: {N} tokens are not a {win}x{win} window")
    if C % num_heads:
        raise ValueError(f"{name}: {C} channels do not split into {num_heads} heads")
    _build.require_head_dim(C // num_heads, name)


def window_attention_rows(qkv_windows, bh, bw, win: int, num_heads: int, group: int = 1):
    """K11: qkv_windows [nW, win*win, 3C] (bias in), bias rows bh, bw [nW,
    heads, win*win, win] -> [nW, win*win, C]. `group` windows a block."""
    if _build.on_cpu(qkv_windows):
        return window_attention_rows_plain(qkv_windows, bh, bw, win, num_heads)
    nW, N, C3 = qkv_windows.shape
    C = C3 // 3
    _check_window(N, C, win, num_heads, "window_attention_rows")
    bf = torch.bfloat16
    _build.require(qkv_windows, "qkv_windows", bf)
    _build.require(bh, "bh", bf, (nW, num_heads, N, win))
    _build.require(bw, "bw", bf, (nW, num_heads, N, win))
    out = torch.empty((nW, N, C), dtype=bf, device=qkv_windows.device)
    _build.check(_build.kernels().samroad_window_attention_rows(
        qkv_windows.data_ptr(), bh.data_ptr(), bw.data_ptr(), out.data_ptr(), nW, C, num_heads,
        win, group_size(group, nW), _build.stream_of(qkv_windows)), "window_attention_rows")
    _build.launches["window_attention_rows"] += 1
    return out


def window_attention_relpos(qkv_windows, rel_pos_h, rel_pos_w, win: int, num_heads: int,
                            group: int = 1):
    """K12: K11 with the bias rows built in the kernel from the rel-pos
    tables rel_pos_h, rel_pos_w (2 win - 1, hd), which the wrapper expands
    to [win*win, win, hd] bf16."""
    if _build.on_cpu(qkv_windows):
        return window_attention_relpos_plain(qkv_windows, rel_pos_h, rel_pos_w, win, num_heads)
    nW, N, C3 = qkv_windows.shape
    C = C3 // 3
    _check_window(N, C, win, num_heads, "window_attention_relpos")
    bf = torch.bfloat16
    _build.require(qkv_windows, "qkv_windows", bf)
    rh, rw = _kernel_tables(rel_pos_h, rel_pos_w, win, C // num_heads)
    out = torch.empty((nW, N, C), dtype=bf, device=qkv_windows.device)
    _build.check(_build.kernels().samroad_window_attention_relpos(
        qkv_windows.data_ptr(), rh.data_ptr(), rw.data_ptr(), out.data_ptr(), nW, C, num_heads,
        win, group_size(group, nW), _build.stream_of(qkv_windows)), "window_attention_relpos")
    _build.launches["window_attention_relpos"] += 1
    return out


def window_attention_relpos_batched(q, k, v, rel_pos_h, rel_pos_w, win: int, group: int = 4):
    """K13: K12's function on head-split q, k, v [nW, heads, win*win, hd] ->
    [nW, heads, win*win, hd]. No padded copy is made: the kernel computes on
    the real keys."""
    if _build.on_cpu(q):
        return window_attention_relpos_batched_plain(q, k, v, rel_pos_h, rel_pos_w, win)
    nW, H, N, hd = q.shape
    _check_window(N, H * hd, win, H, "window_attention_relpos_batched")
    bf = torch.bfloat16
    _build.require(q, "q", bf)
    _build.require(k, "k", bf, q.shape)
    _build.require(v, "v", bf, q.shape)
    rh, rw = _kernel_tables(rel_pos_h, rel_pos_w, win, hd)
    out = torch.empty_like(q)
    _build.check(_build.kernels().samroad_window_attention_relpos_batched(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rh.data_ptr(), rw.data_ptr(), out.data_ptr(),
        nW, H, hd, win, group_size(group, nW), _build.stream_of(q)),
        "window_attention_relpos_batched")
    _build.launches["window_attention_relpos_batched"] += 1
    return out
