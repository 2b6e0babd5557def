"""The batched-product repro on the card: the counterpart of the
repository's tools/repro_aot_crash.py, with its inputs (default_rng(0), a
then b, normal [12, 256, 64] cast to bf16) and its PASS / CRASH lines.

On the TPU a batched dot_general inside a Pallas kernel crashed the remote
compile helper while the same math as a Python loop of 2-D dots over the
heads ran. Here both are launch shapes of one kernel, T13 batched_nt
(csrc/probes.cu): out[h] = bf16(a[h] . b[h]^T), fp32 accumulation.

  looped   one block per 64 x 64 output tile, walking the 12 heads inside
           it, as looped_kernel unrolls them in one program (16 blocks)
  batched  the head as a grid dimension, batched_kernel's dot_general batch
           dimension (192 blocks on 132 SMs)

A line reads "PASS" only if the kernel built, launched and came within
TOL x (1 + |ref|) of the fp32 plain version on the same inputs; otherwise
"CRASH: <message>". Each shape adds `<name>_ms` (CUDA events around `reps`
launches, per launch; host clock with --device cpu) and `<name>_max_err`,
and launches the kernel 1 + reps times.

    python -m sam_road_tpu_torch.tools.repro_aot_crash [--device cpu]
"""

from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from sam_road_tpu_torch.ops import _build
from sam_road_tpu_torch.utils.profiling import ms_per_call

TOL = 2e-2  # |kernel - plain_fp32| <= TOL * (1 + |plain_fp32|), a bf16 kernel
DEPTH = 64  # batched_nt's contraction depth
SHAPES = ("looped", "batched")


def batched_nt_plain(a, b):
    """out[h] = a[h] . b[h]^T in fp32, cast to a.dtype: the bodies of
    tools/repro_aot_crash.py's looped_kernel and batched_kernel (:35-45)."""
    return torch.matmul(a.float(), b.float().transpose(-1, -2)).to(a.dtype)


def batched_nt_grid(heads: int, N: int, looped: bool) -> int:
    """The blocks batched_nt launches on the current card for [heads, N,
    64]: one per (head, 64 x 64 output tile), or min(SMs, that) looped."""
    grid = ctypes.c_int()
    _build.check(_build.kernels().samroad_batched_nt_grid(heads, N, int(looped),
                                                          ctypes.byref(grid)), "batched_nt")
    return grid.value


def batched_nt(a, b, looped: bool = False):
    """T13: a, b [heads, N, 64] bf16 -> a[h] . b[h]^T [heads, N, N] bf16, in
    the looped launch shape (a persistent grid whose blocks walk the (head,
    tile) items) or the batched one (a block per item); the two are
    bit-equal."""
    if _build.on_cpu(a):
        return batched_nt_plain(a, b)
    heads, N, D = a.shape
    bf = torch.bfloat16
    _build.require(a, "a", bf)
    _build.require(b, "b", bf, a.shape)
    if D != DEPTH:
        raise ValueError(f"batched_nt kernel needs depth {DEPTH}, got {tuple(a.shape)}")
    out = a.new_empty((heads, N, N))
    _build.check(_build.kernels().samroad_batched_nt(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), heads, N, D, int(looped),
        _build.stream_of(a)), "batched_nt")
    _build.launches["batched_nt"] += 1
    return out


def main(device: str = "cuda", *, heads: int = 12, tokens: int = 256, depth: int = DEPTH,
         reps: int = 20) -> dict:
    """Returns and prints {shape: "PASS" | "CRASH: ...", shape_ms,
    shape_max_err} for the looped and batched shapes; the geometry
    arguments exist so that a test can run the tool small."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to run the plain versions")
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.normal(size=(heads, tokens, depth))).to(dev, torch.bfloat16)
            for _ in range(2))
    ref = batched_nt_plain(a.float(), b.float())
    results = {}
    for name in SHAPES:
        def run(name=name):
            return batched_nt(a, b, looped=name == "looped")
        try:
            out = run().float()
            err = (out - ref).abs()
            results[name + "_max_err"] = err.max().item()
            rel = (err / (1 + ref.abs())).max().item()
            if not (rel <= TOL and bool(torch.isfinite(out).all())):
                raise ArithmeticError(f"max_rel_err {rel:.3e} over {TOL} against the plain version")
            results[name + "_ms"] = ms_per_call(run, reps, dev)
            results[name] = "PASS"
            print(f"{name}: PASS (sum {out.abs().sum().item():.1f})", flush=True)
        except Exception as e:  # recorded, as the JAX repro records the compile helper's crash
            results[name] = f"CRASH: {str(e)[:200]}"
            print(f"{name}: {results[name]}", flush=True)
    print(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    main(ap.parse_args().device)
