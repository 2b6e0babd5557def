"""The Mosaic lowering probes on the card: the counterpart of the
repository's tools/probe_mosaic.py, with its keys and its default_rng(0)
inputs, each probe a kernel of the port held to its plain version.

  merge_reshape_N196 / _N200  T6 merge_dense: x [32, NP, 256] . W [256, 256]
                              -> bf16, an instance of csrc/gemm.cu over the
                              32 NP rows (the probe's [in, out] W is
                              transposed once, before the probe, to the
                              [out, in] layout the GEMM reads)
  leading_batch_dot_general   T7 batched_dot: the row max of q[b] . q[b]^T,
                              q [32, 200, 64] -> [32, 200]
  lane_slice_64               T8 lane_slice: the row max of x[b][:, 0:64] .
                              x[b][:, 64:128]^T, x [8, 200, 768] -> [8, 200]
T7 and T8 are one kernel, rowmax_dot (csrc/probes.cu), which reads its
operands through row and batch strides and a column offset.

On the TPU each probe asks whether Mosaic lowers a construct, and records
"OK" or the error. Here a value reads "OK" only if the kernel built,
launched and came within TOL x (1 + |ref|) of its plain version in fp32 on
the same inputs; otherwise "FAIL: <message>". Each probe adds `<key>_ms`
(CUDA events around `reps` launches, per launch; host clock with --device
cpu) and `<key>_max_err`. A probe launches its kernel 1 + reps times.

T8 differs from the JAX probe on purpose. There the kernel's block is
(1, 200, 768), so `x[:, 0:64]` slices the token axis, giving (1, 64, 768),
and `jnp.dot(h0, h1.T)` contracts 768 against 64: tracing fails with a
TypeError on every backend, so its "FAIL" never comes from Mosaic. The port
computes the lane split its comment states ("head split from qkv"): the
first two 64-column heads of each image's token rows.

    python -m sam_road_tpu_torch.tools.probe_mosaic [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from sam_road_tpu_torch.ops import _build
from sam_road_tpu_torch.utils.profiling import ms_per_call

TOL = 2e-2  # |kernel - plain_fp32| <= TOL * (1 + |plain_fp32|), bf16 kernels
HEAD = 64   # rowmax_dot's contraction depth


def merge_dense_plain(x, w):
    """Follows mk_merge's kernel (tools/probe_mosaic.py:34-37): x [G, NP,
    C] merged to [G NP, C], times w^T (w [F, C], the probe's W transposed)
    in fp32, cast to x.dtype -> [G, NP, F]."""
    G, NP, C = x.shape
    return torch.matmul(x.reshape(G * NP, C).float(), w.float().t()).to(x.dtype).reshape(G, NP, -1)


def merge_dense(x, w):
    """T6: x [G, NP, C] . w^T, w [F, C] -> [G, NP, F], bf16; C % 64 == 0
    and F % 128 == 0, any G NP."""
    if _build.on_cpu(x):
        return merge_dense_plain(x, w)
    G, NP, C = x.shape
    bf = torch.bfloat16
    _build.require(x, "x", bf)
    _build.require(w, "w", bf)
    if w.shape[1] != C:
        raise ValueError(f"merge_dense kernel needs w [F, {C}], got x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    _build.gemm_block_n(w.shape[0], C, "merge_dense")
    out = torch.empty((G, NP, w.shape[0]), dtype=bf, device=x.device)
    _build.check(_build.kernels().samroad_merge_dense(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), G * NP, w.shape[0], C,
        _build.stream_of(x)), "merge_dense")
    _build.launches["merge_dense"] += 1
    return out


def rowmax_dot_plain(a, b):
    """out[i, n] = max_m sum_c a[i, n, c] b[i, m, c], the product in fp32,
    cast to a.dtype: batched_dot's and lane_slice's kernels
    (tools/probe_mosaic.py:65-72, :91-99)."""
    return torch.matmul(a.float(), b.float().transpose(-1, -2)).amax(-1).to(a.dtype)


def _rowmax_dot(x, a_col: int, b_col: int, name: str):
    """rowmax_dot over the HEAD columns of x [B, N, W] from a_col and from
    b_col -> [B, N] bf16."""
    B, N, W = x.shape
    _build.require(x, "x", torch.bfloat16)
    out = x.new_empty((B, N))
    _build.check(_build.kernels().samroad_rowmax_dot(
        x.data_ptr(), x.data_ptr(), out.data_ptr(), B, N, HEAD, W, N * W, a_col, b_col,
        _build.stream_of(x)), name)
    _build.launches[name] += 1
    return out


def batched_dot(q):
    """T7: the row max of q[b] . q[b]^T, q [B, N, 64] -> [B, N]."""
    if _build.on_cpu(q):
        return rowmax_dot_plain(q, q)
    if q.shape[-1] != HEAD:
        raise ValueError(f"batched_dot kernel needs {HEAD} columns, got {tuple(q.shape)}")
    return _rowmax_dot(q, 0, 0, "batched_dot")


def lane_slice(x):
    """T8: the row max of x[b][:, 0:64] . x[b][:, 64:128]^T, x [B, N, C]
    with C >= 128 (C % 8 == 0) -> [B, N]."""
    if _build.on_cpu(x):
        return rowmax_dot_plain(x[..., :HEAD], x[..., HEAD:2 * HEAD])
    if x.shape[-1] < 2 * HEAD or x.shape[-1] % 8:
        raise ValueError(f"lane_slice kernel needs at least {2 * HEAD} columns, a multiple "
                         f"of 8, got {tuple(x.shape)}")
    return _rowmax_dot(x, 0, HEAD, "lane_slice")


def main(device: str = "cuda", *, batch: int = 32, tokens: int = 200, merge_tokens=(196, 200),
         channels: int = 256, width: int = 768, reps: int = 20) -> dict:
    """Returns and prints {key: "OK" | "FAIL: ...", key_ms, key_max_err}.
    Inputs are drawn in the JAX tool's order (x and W at each NP, q, then
    x of lane_slice, which has batch // 4 images), each W transposed once
    here, outside the timed calls; the geometry arguments
    exist so that a test can run the tool small."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to run the plain versions")
    rng = np.random.default_rng(0)

    def arr(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, torch.bfloat16)

    probes = {}  # key -> (kernel, plain, inputs)
    for NP in merge_tokens:
        probes[f"merge_reshape_N{NP}"] = (merge_dense, merge_dense_plain,
                                          (arr(batch, NP, channels),
                                           arr(channels, channels).t().contiguous()))
    probes["leading_batch_dot_general"] = (batched_dot, lambda q: rowmax_dot_plain(q, q),
                                           (arr(batch, tokens, HEAD),))
    probes["lane_slice_64"] = (lane_slice, lambda x: rowmax_dot_plain(x[..., :HEAD],
                                                                      x[..., HEAD:2 * HEAD]),
                               (arr(batch // 4, tokens, width),))
    results = {}
    for key, (kern, plain, args) in probes.items():
        try:
            got = kern(*args)
            ref = plain(*[t.float() for t in args])
            err = (got.float() - ref).abs()
            results[key + "_max_err"] = err.max().item()
            rel = (err / (1 + ref.abs())).max().item()
            if not (rel <= TOL and bool(torch.isfinite(got.float()).all())):
                raise ArithmeticError(f"max_rel_err {rel:.3e} over {TOL} against the plain version")
            results[key + "_ms"] = ms_per_call(lambda: kern(*args), reps, dev)
            results[key] = "OK"
        except Exception as e:  # recorded, as the JAX probe records a lowering error
            results[key] = f"FAIL: {str(e)[:160]}"
        print(f"# {key}: {results[key]}", flush=True)
    print(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    main(ap.parse_args().device)
