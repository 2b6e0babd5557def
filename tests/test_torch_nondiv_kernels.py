"""The tools' kernels T9-T12 (probe_nondiv_blocks: nondiv_read_write,
nondiv_out_exact, inkernel_pad_loop, oversized_sublane_block) and T13
(repro_aot_crash.batched_nt, looped and batched) against Pallas kernels in
interpret mode on the CPU, and both tools run small.

On CPU tensors the wrappers take their plain PyTorch versions, so these
tests hold those, in fp32 on np.random.default_rng inputs, to the probe
kernels' bodies restated here at small sizes (the tools hard-code their
shapes and jit without interpret, and nothing under tools/ is imported):
T9 / T10 in blocks of 4 rows over H 10, so the last block is partial; T11
over W 10 in windows of 4 (nJ 3), T12 from a 16-wide block over those 10
columns; T13 on 1-4 heads of [N, 8], N 1 to 20, both bodies. T9 and T10
exact (a masked copy, one multiply and one add, rounded alike), T11-T13
within 1e-5 (the same sums in another order). The CUDA kernels are held to
these plain versions in tests/test_torch_cuda_kernels.py. T9 / T10's check
of a caller's `out` (its dtype, shape, strides and alignment) is tested on
CPU tensors.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sam_road_tpu_torch.tools import probe_nondiv_blocks as pnb
from sam_road_tpu_torch.tools import repro_aot_crash as rac

B, H, W, C, WIN = 2, 10, 10, 8, 4
NI = -(-H // WIN)  # 3 row blocks, the last partial
NJ = -(-W // WIN)  # 3 window columns, the last partial
TOL = dict(rtol=1e-5, atol=1e-5)
t = torch.from_numpy


def _rows_pallas(x, body, out_rows):
    """A probe kernel over blocks (1, WIN, W, C) on the grid (B, NI), its
    output out_rows rows high (tools/probe_nondiv_blocks.py:40-48, :73-81)."""
    spec = pl.BlockSpec((1, WIN, W, C), lambda b, i: (b, i, 0, 0), memory_space=pltpu.VMEM)
    return pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct((B, out_rows, W, C), jnp.float32), grid=(B, NI),
        in_specs=[spec], out_specs=spec, interpret=True)(jnp.asarray(x))


def test_nondiv_read_write_matches_pallas_partial_block():
    """T9: rows past H masked to 0 in the kernel, plus 1, out NI WIN rows:
    the pad rows are exactly 1.0."""
    x = np.random.default_rng(60).normal(size=(B, H, W, C)).astype(np.float32)

    def kernel(x_ref, o_ref):
        i = pl.program_id(1)
        r = jax.lax.broadcasted_iota(jnp.int32, (WIN, W, C), 0)
        o_ref[0] = jnp.where(i * WIN + r < H, x_ref[0], 0.0) + 1.0

    want = np.asarray(_rows_pallas(x, kernel, NI * WIN))
    got = pnb.nondiv_read_write(t(x), WIN).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, H:], 1.0)


def test_nondiv_out_exact_matches_pallas_and_writes_only_its_rows():
    """T10: 2 x into an output of exactly H rows; through a view of H rows
    of a taller buffer the rows past H keep their NaN."""
    x = np.random.default_rng(61).normal(size=(B, H, W, C)).astype(np.float32)

    def kernel(x_ref, o_ref):
        o_ref[0] = x_ref[0] * 2.0

    want = np.asarray(_rows_pallas(x, kernel, H))
    np.testing.assert_array_equal(pnb.nondiv_out_exact(t(x), WIN).numpy(), want)
    buf = torch.full((B, H + pnb.GUARD_ROWS, W, C), math.nan)
    pnb.nondiv_out_exact(t(x), WIN, out=buf[:, :H])
    np.testing.assert_array_equal(buf[:, :H].numpy(), want)
    assert torch.isnan(buf[:, H:]).all()


def _colsum_pallas(x, block_cols, padded):
    """The window-sum probes on the grid (B,) with blocks (1, WIN, block_cols,
    C): the row padded to NJ WIN columns in the kernel and sliced
    (probe_inkernel_pad_loop, :102-123), or read from an oversized block at
    unaligned starts with the columns past W masked
    (probe_oversized_sublane_block, :158-178)."""

    def kernel(x_ref, o_ref):
        def body(j, _):
            if padded:
                xp = jnp.pad(x_ref[0], ((0, 0), (0, NJ * WIN - W), (0, 0)))
                tile = jax.lax.dynamic_slice(xp, (0, j * WIN, 0), (WIN, WIN, C))
            else:
                tile = x_ref[0, :, pl.ds(j * WIN, WIN), :]
                col = jax.lax.broadcasted_iota(jnp.int32, (WIN, WIN, C), 1)
                tile = jnp.where(j * WIN + col < W, tile, 0.0)
            o_ref[0, :, pl.ds(j, 1), :] = jnp.sum(tile, axis=1, keepdims=True)
            return 0

        jax.lax.fori_loop(0, NJ, body, 0)

    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((B, WIN, NJ, C), jnp.float32), grid=(B,),
        in_specs=[pl.BlockSpec((1, WIN, block_cols, C), lambda b: (b, 0, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, WIN, NJ, C), lambda b: (b, 0, 0, 0),
                               memory_space=pltpu.VMEM),
        interpret=True)(jnp.asarray(x))


@pytest.mark.parametrize("name,block_cols,padded", [("inkernel_pad_loop", W, True),
                                                    ("oversized_sublane_block", 16, False)])
def test_window_colsum_matches_pallas_probe(name, block_cols, padded):
    """T11 (the in-kernel pad and loop) and T12 (a 16-wide block over 10
    columns, unaligned starts, masked columns) on [2, 4, 10, 8]."""
    x = np.random.default_rng(62).normal(size=(B, WIN, W, C)).astype(np.float32)
    want = _colsum_pallas(x, block_cols, padded)
    got = getattr(pnb, name)(t(x), WIN)
    assert got.shape == (B, WIN, NJ, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (heads, N) of the T13 cases; the first keeps its cases' ids "True" / "False"
NT_SHAPES = [(3, 16), (1, 16), (1, 13), (4, 20), (2, 1)]


@pytest.mark.parametrize("looped,heads,N", [
    pytest.param(looped, h, n, id=f"{looped}" if i == 0 else f"{looped}-{h}x{n}")
    for i, (h, n) in enumerate(NT_SHAPES) for looped in (True, False)])
def test_batched_nt_matches_pallas_repro_bodies(looped, heads, N):
    """T13: a[h] . b[h]^T on `heads` heads of [N, 8] (N 13 and 20 no
    multiple of 16, N 1 a lone element; one head and several), against
    looped_kernel (a Python loop of 2-D dots) and batched_kernel (one
    batched dot_general), tools/repro_aot_crash.py:35-45, in fp32."""
    r = np.random.default_rng(63)
    a, b = (r.normal(size=(heads, N, 8)).astype(np.float32) for _ in range(2))

    def looped_kernel(a_ref, b_ref, o_ref):
        for i in range(heads):
            o_ref[i] = jnp.dot(a_ref[i], b_ref[i].T, preferred_element_type=jnp.float32)

    def batched_kernel(a_ref, b_ref, o_ref):
        o_ref[...] = jax.lax.dot_general(a_ref[...], b_ref[...], (((2,), (2,)), ((0,), (0,))),
                                         preferred_element_type=jnp.float32)

    spec = pl.BlockSpec(memory_space=pltpu.VMEM)
    want = pl.pallas_call(
        looped_kernel if looped else batched_kernel,
        out_shape=jax.ShapeDtypeStruct((heads, N, N), jnp.float32), in_specs=[spec, spec],
        out_specs=spec, interpret=True)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(rac.batched_nt(t(a), t(b), looped=looped).numpy(),
                               np.asarray(want), **TOL)


def _out_buffer(offset: int = 0, image: int = H * W * C, rows: int = H, row_stride: int = W * C):
    """[B, rows, W, C] fp32 over a flat CPU buffer: images `image` elements
    apart, rows `row_stride` apart, from element `offset`."""
    flat = torch.zeros(offset + B * max(image, rows * row_stride) + 64)
    return flat.as_strided((B, rows, W, C), (image, row_stride, C, 1), offset)


@pytest.mark.parametrize("case,out", [
    ("exact", lambda: torch.empty(B, H, W, C)),
    ("view of a taller buffer", lambda: torch.empty(B, H + pnb.GUARD_ROWS, W, C)[:, :H]),
    ("images 4 elements further apart", lambda: _out_buffer(image=H * W * C + 4)),
])
def test_check_out_accepts(case, out):
    """T9 / T10's `out` check passes what the kernel can write: fp32 rows
    of W C contiguous elements, images a multiple of 4 elements and at
    least H rows apart, 16-byte aligned."""
    pnb.check_out(out(), torch.zeros(B, H, W, C), H, "nondiv_out_exact")


@pytest.mark.parametrize("case,out", [
    ("wrong dtype", lambda: torch.empty(B, H, W, C, dtype=torch.float64)),
    ("wrong shape", lambda: torch.empty(B, H + 1, W, C)),
    ("non-contiguous rows", lambda: _out_buffer(row_stride=W * C + 4, image=H * (W * C + 4))),
    ("channels strided", lambda: torch.empty(B, H, W, 2 * C)[..., ::2]),
    ("misaligned image stride", lambda: _out_buffer(image=H * W * C + 2)),
    ("image stride shorter than out_rows rows", lambda: _out_buffer(image=H * W * C - 4)),
    ("misaligned start", lambda: _out_buffer(offset=1)),
])
def test_check_out_refuses(case, out):
    """T9 / T10's `out` check raises ValueError, on CPU tensors, for what
    the kernel cannot write: the wrong dtype or shape, rows that are not
    contiguous, an image stride that is no multiple of 4 or shorter than
    out_rows rows (images would overlap), a start off 16 bytes."""
    with pytest.raises(ValueError, match="needs out fp32"):
        pnb.check_out(out(), torch.zeros(B, H, W, C), H, "nondiv_out_exact")


def _counted(monkeypatch, module, names):
    """Count the calls of module.<name> for each name (the tools look their
    kernels up at call time), as chip_smoke.py counts their launches."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        def counted(*a, _name=name, _fn=getattr(module, name), **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(module, name, counted)
    return calls


def test_probe_nondiv_blocks_runs_small_on_cpu(monkeypatch):
    """The probe tool on [2, 10, 10, 8] in blocks of 4: the JAX verdict's
    three keys True, each with a time and a max error (0 for T9 and T10),
    each probe's kernel called 1 + reps times; then the probe main() leaves
    out, T12, True in 1 + reps calls."""
    names = ["nondiv_read_write", "nondiv_out_exact", "inkernel_pad_loop",
             "oversized_sublane_block"]
    calls = _counted(monkeypatch, pnb, names)
    res = pnb.main("cpu", batch=B, rows=H, width=W, channels=C, win=WIN, reps=3)
    keys = ["nondiv_read", "oob_write", "pad_loop"]
    assert sorted(res) == sorted(k + s for k in keys for s in ("", "_ms", "_max_err"))
    assert [res[k] for k in keys] == [True] * 3
    assert res["nondiv_read_max_err"] == res["oob_write_max_err"] == 0.0
    assert math.isfinite(res["pad_loop_ms"]) and res["pad_loop_max_err"] <= pnb.SUM_TOL
    assert calls == dict(zip(names, [4, 4, 4, 0]))
    res = pnb.probe_oversized_sublane_block("cpu", batch=B, width=W, channels=C, win=WIN, reps=3)
    assert res["oversized_block"] is True and calls["oversized_sublane_block"] == 4


def test_repro_aot_crash_runs_small_on_cpu(monkeypatch):
    """The repro on 3 heads of [16, 8]: both shapes "PASS", each with a time
    and a max error, the kernel called 1 + reps times for each."""
    calls = _counted(monkeypatch, rac, ["batched_nt"])
    res = rac.main("cpu", heads=3, tokens=16, depth=8, reps=3)
    assert sorted(res) == sorted(s + k for s in rac.SHAPES for k in ("", "_ms", "_max_err"))
    assert [res[s] for s in rac.SHAPES] == ["PASS", "PASS"]
    assert all(math.isfinite(res[s + "_ms"]) for s in rac.SHAPES)
    assert calls == {"batched_nt": 2 * 4}
