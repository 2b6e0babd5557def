"""The tools' kernels T5 (experiment_block_variants.inker_attention) and
T6-T8 (probe_mosaic.merge_dense, batched_dot, lane_slice) against Pallas
kernels in interpret mode on the CPU, and both tools run small.

On CPU tensors the wrappers take their plain PyTorch versions, so these
tests hold those, in fp32 on np.random.default_rng inputs, to JAX: T5 on a
window (window 4, head_dim 8, 12 (window, head) pairs) to
fused_block.py::window_attention_relpos_batched, whose function it is at one
head, and on a 6x6 grid to attention.py::attention_relpos_rows fed q hd^-0.5
and the bias rows from the expanded tables; T6 (NP 6 and 8), T7 and T8 to
the probe kernels' bodies restated here at small sizes (the tools' bodies
live inside their main() and cannot be imported). T8's restated body slices
the last axis, as the probe means it; the body as tools/probe_mosaic.py
writes it fails to trace, which the last probe test pins. rtol = atol = 2e-5
as tests/test_fused_attention.py: the same math summed in another order.
Nothing under tools/ is imported. The CUDA kernels are held to these plain
versions in tests/test_torch_cuda_kernels.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sam_road_tpu.ops import attention as jattn
from sam_road_tpu.ops import fused_block as jblock
from sam_road_tpu_torch.ops import fused_block
from sam_road_tpu_torch.tools import experiment_block_variants as block_variants
from sam_road_tpu_torch.tools import probe_mosaic

WIN, HEADS, HD, NW = 4, 2, 8, 6
N = WIN * WIN
TOL = dict(rtol=2e-5, atol=2e-5)
t = torch.from_numpy


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _tables(r, side):
    rh, rw = ((0.1 * r.normal(size=(2 * side - 1, HD))).astype(np.float32) for _ in range(2))
    return rh, rw, fused_block.expand_rel_pos(t(rh), t(rw), side, torch.float32)


def test_inker_attention_window_matches_pallas_relpos_batched():
    """T5 on 12 (window, head) pairs of a 4x4 window equals K13 at one head:
    the same bias from the unscaled q, scale hd^-0.5, p normalised first."""
    r = np.random.default_rng(50)
    q, k, v = (r.normal(size=(NW, HEADS, N, HD)).astype(np.float32) for _ in range(3))
    rh, rw, (Rh, Rw) = _tables(r, WIN)
    want = jblock.window_attention_relpos_batched(*map(jnp.asarray, (q, k, v, rh, rw)), WIN,
                                                  interpret=True)
    flat = [t(a).reshape(NW * HEADS, N, HD) for a in (q, k, v)]
    got = block_variants.inker_attention(*flat, Rh, Rw, WIN, WIN)
    _close(got.reshape(NW, HEADS, N, HD), want)


def test_inker_attention_global_matches_pallas_relpos_rows():
    """T5 over a whole 6x6 grid equals K3 fed the pre-scaled q and the bias
    rows q.rh, q.rw of the expanded tables (from the unscaled q)."""
    r = np.random.default_rng(51)
    B, side = 2, 6
    Ng = side * side
    q, k, v = (r.normal(size=(B, HEADS, Ng, HD)).astype(np.float32) for _ in range(3))
    _, _, (Rh, Rw) = _tables(r, side)
    bh, bw = (torch.einsum("bhnc,nac->bhna", t(q), R).numpy() for R in (Rh, Rw))
    want = jattn.attention_relpos_rows(*map(jnp.asarray, (q * HD ** -0.5, k, v, bh, bw)),
                                       (side, side), interpret=True)
    flat = [t(a).reshape(B * HEADS, Ng, HD) for a in (q, k, v)]
    got = block_variants.inker_attention(*flat, Rh, Rw, side, side)
    _close(got.reshape(B, HEADS, Ng, HD), want)


def _merge_pallas(x, w, G):
    """tools/probe_mosaic.py's mk_merge kernel (:34-52) for G windows a
    program, any NP."""
    GP, NP, C = x.shape

    def kern(x_ref, w_ref, o_ref):
        h = x_ref[...].reshape(G * NP, C)
        y = jnp.dot(h, w_ref[...], preferred_element_type=jnp.float32)
        o_ref[...] = y.astype(o_ref.dtype).reshape(G, NP, C)

    return pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype), grid=(GP // G,),
        in_specs=[pl.BlockSpec((G, NP, C), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec((C, C), lambda i: (0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((G, NP, C), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        interpret=True)(x, w)


@pytest.mark.parametrize("NP", [6, 8])
def test_merge_dense_matches_pallas_merge_probe(NP):
    """T6: (G, NP, C) merged to (G NP, C) times W [in, out], at NP 6 (no
    multiple of 8, as 196) and 8 (as 200); the port takes W transposed."""
    r = np.random.default_rng(52 + NP)
    x = r.normal(size=(6, NP, 16)).astype(np.float32)
    w = r.normal(size=(16, 16)).astype(np.float32)
    _close(probe_mosaic.merge_dense(t(x), t(np.ascontiguousarray(w.T))),
           _merge_pallas(jnp.asarray(x), jnp.asarray(w), 2))


@pytest.mark.parametrize("peaked", [False, True])
def test_batched_dot_matches_pallas_leading_batch_probe(peaked):
    """T7: the row max of q.q^T per batch, against batched_dot's kernel
    (:65-72) with 2 batches a program; also on rows s_n u_b whose maxima
    lie off the diagonal (s 3 and -3 at one row each)."""
    r = np.random.default_rng(53)
    q = r.normal(size=(6, 10, 8)).astype(np.float32)
    G, Nq, D = 2, 10, 8
    if peaked:
        s = r.uniform(-1, 1, size=(6, Nq))
        s[:, 3], s[:, 8] = 3.0, -3.0
        q = (s[..., None] * r.normal(size=(6, 1, D)) + 0.1 * q).astype(np.float32)

    def kern(q_ref, o_ref):
        qv = q_ref[...]
        s = jax.lax.dot_general(qv, qv, dimension_numbers=(((2,), (2,)), ((0,), (0,))),
                                preferred_element_type=jnp.float32)
        o_ref[...] = s.max(axis=-1).astype(o_ref.dtype)

    want = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((6, Nq), jnp.float32), grid=(3,),
        in_specs=[pl.BlockSpec((G, Nq, D), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((G, Nq), lambda i: (i, 0), memory_space=pltpu.VMEM),
        interpret=True)(jnp.asarray(q))
    _close(probe_mosaic.batched_dot(t(q)), want)


def _lane_slice_pallas(x, as_written: bool):
    """lane_slice's kernel (:91-112), one image a program: as the probe
    writes it (`x_ref[...]` keeps the leading block axis, so the slices cut
    the token axis) or as it means it (the two 64-column heads)."""
    B, Nt, C = x.shape

    def kern(x_ref, o_ref):
        x = x_ref[...] if as_written else x_ref[0]
        h0 = x[:, 0:64]
        h1 = x[:, 64:128]
        o_ref[...] = (jnp.dot(h0, h1.T, preferred_element_type=jnp.float32)
                      .max(axis=-1).reshape(o_ref.shape).astype(o_ref.dtype))

    return pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((B, Nt), x.dtype), grid=(B,),
        in_specs=[pl.BlockSpec((1, Nt, C), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, Nt), lambda i: (i, 0), memory_space=pltpu.VMEM),
        interpret=True)(x)


def test_lane_slice_matches_pallas_head_split():
    """T8: the row max of x[b][:, 0:64] . x[b][:, 64:128]^T on 3 images of
    10 tokens, 192 columns."""
    x = np.random.default_rng(54).normal(size=(3, 10, 192)).astype(np.float32)
    _close(probe_mosaic.lane_slice(t(x)), _lane_slice_pallas(jnp.asarray(x), False))


def test_lane_slice_probe_as_written_fails_to_trace():
    """The JAX probe's body on its own (8, 200, 768) input contracts 768
    against 64 and raises at trace time: a shape error on every backend,
    which the JAX tool records as lane_slice_64's FAIL."""
    with pytest.raises(TypeError, match="contracting dimensions"):
        _lane_slice_pallas(jnp.zeros((8, 200, 768), jnp.float32), True)


def _finite(results, keys):
    assert sorted(results) == sorted(keys)
    return all(isinstance(results[k], str) or math.isfinite(results[k]) for k in keys)


def _counted(monkeypatch, module, names):
    """Count the calls of module.<name> for each name (the tools look their
    kernels up at call time), as chip_smoke.py counts their launches."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        def counted(*a, _name=name, _fn=getattr(module, name)):
            calls[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(module, name, counted)
    return calls


def test_experiment_block_variants_runs_small_on_cpu(monkeypatch):
    """The T5 tool on one 6x6 patch at window 4: the JAX keys
    {win,glob}_{flash,xla,inker}_ms, every variant's L1 within 1e-2 of the
    xla block's (the same weights), and T5 called 1 + reps * iters times a
    block, the launches chip_smoke.py expects on the card."""
    calls = _counted(monkeypatch, block_variants, ["inker_attention"])
    res = block_variants.main("cpu", batch=1, grid=6, dim=HEADS * HD, heads=HEADS, win=WIN,
                              iters=2, reps=2)
    labels = [f"{lb}_{sub}" for lb in ("win", "glob") for sub in ("flash", "xla", "inker")]
    assert _finite(res, [f"{lb}_{k}" for lb in labels for k in ("ms", "l1")])
    for kern, plain in block_variants.PAIRS.items():
        assert abs(res[f"{kern}_l1"] / res[f"{plain}_l1"] - 1) <= 1e-2, kern
    assert calls == {"inker_attention": 2 * (1 + 2 * 2)}


def test_probe_mosaic_runs_small_on_cpu(monkeypatch):
    """The probe tool at small shapes: its four JAX keys all "OK", each with
    a time and a max error, and each probe's kernel called 1 + reps times."""
    calls = _counted(monkeypatch, probe_mosaic, ["merge_dense", "batched_dot", "lane_slice"])
    res = probe_mosaic.main("cpu", batch=4, tokens=10, merge_tokens=(6, 8), channels=32,
                            width=192, reps=3)
    keys = ["merge_reshape_N6", "merge_reshape_N8", "leading_batch_dot_general",
            "lane_slice_64"]
    assert _finite(res, [k + s for k in keys for s in ("", "_ms", "_max_err")])
    assert [res[k] for k in keys] == ["OK"] * 4
    assert calls == {"merge_dense": 2 * (1 + 3), "batched_dot": 1 + 3, "lane_slice": 1 + 3}
