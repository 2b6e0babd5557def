"""The tools' kernels of the port, T1 (experiment_group_window.diag_attn),
T2 / T3 (experiment_window_attn.window_attn_kernel1 / window_attn_grouped)
and T4 (experiment_relpos_kernel.sel_attention), against the JAX package's
Pallas kernels in interpret mode on the CPU, and the three tools run small.

On CPU tensors the wrappers take their plain PyTorch versions, so these
tests hold those in fp32, at the JAX tests' sizes (window 4, 2 heads,
head_dim 8, 6 windows), to the JAX function each tool measures its kernel
against: T1 to fused_block.py::window_attention_rows (the tool's own
reference), T2 to attention.py::fused_attention at D = hd + 2 win (the
rel-pos folded into q and k), T4 to fused_block.py::
window_attention_relpos_batched fed the pre-scaled q and the bias rows from
the tables. rtol = atol = 2e-5 as tests/test_fused_attention.py: the same
math summed in another order. None of them imports anything under tools/.
The CUDA kernels are held to these plain versions in
tests/test_torch_cuda_kernels.py.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sam_road_tpu.ops import attention as jattn
from sam_road_tpu.ops import fused_block as jblock
from sam_road_tpu_torch.ops import fused_block
from sam_road_tpu_torch.tools import (
    experiment_group_window as group_window,
    experiment_relpos_kernel as relpos_kernel,
    experiment_window_attn as window_attn,
)

WIN, HEADS, HD, NW = 4, 2, 8, 6
N, C = WIN * WIN, HEADS * HD
TOL = dict(rtol=2e-5, atol=2e-5)
t = torch.from_numpy


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("g", [2, 3])
def test_diag_attn_plain_matches_pallas_window_attention_rows(g):
    """T1 with g windows a fold (cross-window scores masked to -1e30)
    equals K11 on the same windows, the relation the tool checks."""
    r = np.random.default_rng(40)
    qkv = r.normal(size=(NW, N, 3 * C)).astype(np.float32)
    bh, bw = (r.normal(size=(NW, HEADS, N, WIN)).astype(np.float32) for _ in range(2))
    want = jblock.window_attention_rows(*map(jnp.asarray, (qkv, bh, bw)), WIN, HEADS,
                                        interpret=True)
    got = group_window.diag_attn(t(qkv), t(bh), t(bw), g)
    _close(got, want)
    assert torch.equal(got, group_window.diag_attn_plain(t(qkv), t(bh), t(bw), g))


def _folded_inputs(seed, BH=NW * HEADS):
    r = np.random.default_rng(seed)
    D = HD + 2 * WIN
    q, k = ((0.5 * r.normal(size=(BH, N, D))).astype(np.float32) for _ in range(2))
    return q, k, r.normal(size=(BH, N, HD)).astype(np.float32)


def test_window_attn_kernel1_plain_matches_pallas_fused_attention():
    """T2 (unscaled, p divided after p.v) against the JAX fused_attention
    over the same folded q and k."""
    q, k, v = _folded_inputs(41)
    want = jattn.fused_attention(*(jnp.asarray(a[None]) for a in (q, k, v)), True)[0]
    _close(window_attn.window_attn_kernel1(t(q), t(k), t(v)), want)


@pytest.mark.parametrize("G", [2, 3])
def test_window_attn_grouped_plain_equals_kernel1(G):
    """T3's plain version at G windows a program gives T2's output exactly."""
    q, k, v = map(t, _folded_inputs(42))
    assert torch.equal(window_attn.window_attn_grouped(q, k, v, G),
                       window_attn.window_attn_kernel1(q, k, v))


def test_sel_attention_plain_matches_pallas_relpos_batched():
    """T4 on pre-scaled q and the bias rows q.Rh, q.Rw of the expanded
    tables equals K13, which scales q and builds the rows itself."""
    r = np.random.default_rng(43)
    q, k, v = (r.normal(size=(NW, HEADS, N, HD)).astype(np.float32) for _ in range(3))
    rh, rw = ((0.1 * r.normal(size=(2 * WIN - 1, HD))).astype(np.float32) for _ in range(2))
    want = jblock.window_attention_relpos_batched(*map(jnp.asarray, (q, k, v, rh, rw)), WIN,
                                                  interpret=True)
    Rh, Rw = fused_block.expand_rel_pos(t(rh), t(rw), WIN, torch.float32)  # [N, win, hd]
    qh, qw = (torch.einsum("whnc,nac->whna", t(q), R) for R in (Rh, Rw))
    flat = [a.reshape(NW * HEADS, N, -1) for a in (t(q) * HD ** -0.5, t(k), t(v), qh, qw)]
    got = relpos_kernel.sel_attention(*flat).reshape(NW, HEADS, N, HD)
    _close(got, want)


def _finite(results, keys):
    assert sorted(results) == sorted(keys)
    return all(isinstance(results[k], list) or math.isfinite(results[k]) for k in keys)


def test_experiment_group_window_runs_small_on_cpu():
    """The T1 tool at window 4, 2 heads, 6 windows, g 2 and 3: the JAX keys,
    each fold within 1e-2 relative L1 of K11 (on the CPU both are plain)."""
    res = group_window.main((2, 3), "cpu", windows=NW, win=WIN, dim=C, heads=HEADS, iters=1,
                            rounds=2)
    labels = ["prod_rows", "diag_g2", "diag_g3"]
    assert _finite(res, [f"{lb}_{k}" for lb in labels for k in ("reldiff", "ms", "all")])
    assert all(res[f"{lb}_reldiff"] <= 1e-2 and len(res[f"{lb}_all"]) == 2 for lb in labels)


def test_experiment_window_attn_runs_small_on_cpu():
    """The T2 / T3 tool at 16 (window, head) pairs: the JAX keys xla_ms,
    kernel1_ms, kernel_g4_ms, kernel_g16_ms and each variant's L1 within
    1e-2 of the plain einsum formulation's."""
    res = window_attn.main("cpu", batch=2, heads=HEADS, win=WIN, windows=4, hd=HD, iters=1,
                           reps=1)
    labels = ["xla", "kernel1", "kernel_g4", "kernel_g16"]
    assert _finite(res, [f"{lb}_{k}" for lb in labels for k in ("ms", "l1")])
    for kern, plain in window_attn.PAIRS.items():
        assert abs(res[f"{kern}_l1"] / res[f"{plain}_l1"] - 1) <= 1e-2, kern


def test_experiment_relpos_kernel_runs_small_on_cpu():
    """The T4 tool on one 6x6 patch at window 4: the JAX keys v0_current_ms
    and v1_selector_ms, both blocks' L1 within 1e-2 of the plain block's
    (the same weights), and the combined variant raises as the JAX one."""
    res = relpos_kernel.main("cpu", batch=1, grid=6, dim=C, heads=HEADS, win=WIN, iters=1,
                             reps=1)
    labels = ["v0_current", "v1_selector"]
    assert _finite(res, [f"{lb}_{k}" for lb in labels for k in ("ms", "l1")]
                   + ["plain_block_l1"])
    for kern, plain in relpos_kernel.PAIRS.items():
        assert abs(res[f"{kern}_l1"] / res[f"{plain}_l1"] - 1) <= 1e-2, kern
    with pytest.raises(NotImplementedError):
        relpos_kernel.SelBlock(C, HEADS, WIN, combined=True)(torch.zeros(1, 6, 6, C))
