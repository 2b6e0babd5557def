"""The non-dividing block probes on the card: the counterpart of the
repository's tools/probe_nondiv_blocks.py, with its shapes (B 2, H 32 or
14, W 32, C 256, win 14), its default_rng(0) ... (3) inputs, one per probe,
and its verdict, each probe a kernel of the port held to its plain version.

  Q1/Q2 nondiv_read   T9 nondiv_read_write: rows in blocks of 14 over 32
                      (the third block partial), rows past H read as 0, plus
                      1 -> [B, 42, W, C]
  Q3    oob_write     T10 nondiv_out_exact: 2 x into an output of exactly H
                      rows, written through a view of a buffer whose guard
                      rows past H hold NaN
  Q4    pad_loop      T11 inkernel_pad_loop: each 14-column window of a row
                      summed from a zero-padded staged copy -> [B, 14, 3, C]
  Q5/Q6 oversized_block
                      T12 oversized_sublane_block: the same sums read from
                      global memory at unaligned starts j 14 through a
                      column mask (the JAX tool's 48-wide block)
T9 and T10 are one kernel, row_block_affine, T11 and T12 one kernel,
window_colsum, in two modes (csrc/probes.cu). row_block_affine has no
row blocks: the function depends on win only through the number of rows
out, which the wrapper computes.

On the TPU each probe asks whether Mosaic lowers a construct and what the
out-of-bounds part of a block holds. On the card a block is an address
range the kernel computes itself: the partial block's reads past H and
writes past the output are guards, never made. A verdict here is True
only if the kernel built, launched and came within the probe's tolerance
of its plain version in fp32 on the same inputs (exact for T9 and T10, 1e-4
for T11 and T12 as the JAX probe allows), and T10's guard rows are still
NaN. Each probe adds `<key>_ms` (CUDA events around `reps` launches, per
launch; host clock with --device cpu) and `<key>_max_err`, and launches its
kernel 1 + reps times.

main() runs the three probes the JAX script's __main__ runs; as there,
probe_oversized_sublane_block is a function of the tool that main() does
not call.

    python -m sam_road_tpu_torch.tools.probe_nondiv_blocks [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from sam_road_tpu_torch.ops import _build
from sam_road_tpu_torch.utils.profiling import ms_per_call

WIN = 14
SUM_TOL = 1e-4  # the JAX probes' atol for the window sums
GUARD_ROWS = 4  # T10: NaN rows past H in each image of the output buffer


def row_block_affine_plain(x, out_rows: int, scale: float, shift: float):
    """y[b, r] = (x[b, r] if r < H else 0) * scale + shift for r < out_rows,
    x [B, H, W, C]: the Pallas bodies of probe_nondiv_read_write (rows past
    H masked to 0, plus 1) and probe_nondiv_out_exact (2 x)."""
    y = x.new_zeros((x.shape[0], out_rows) + tuple(x.shape[2:]))
    n = min(out_rows, x.shape[1])
    y[:, :n] = x[:, :n]
    return y * scale + shift


def check_out(out, x, out_rows: int, name: str) -> None:
    """Raise ValueError unless `out` can take row_block_affine's result for x
    [B, H, W, C]: fp32 [B, out_rows, W, C] on x's device, its rows
    contiguous, its images a multiple of 4 elements and at least out_rows
    rows apart, 16-byte aligned (a view of out_rows rows of a taller buffer
    passes). Only an `out` the caller gave needs it."""
    B, _, W, C = x.shape
    row = W * C
    if (out.device != x.device or out.dtype != torch.float32
            or out.shape != (B, out_rows, W, C) or out.stride()[1:] != (row, C, 1)
            or out.stride(0) % 4 or out.stride(0) < out_rows * row or out.data_ptr() % 16):
        raise ValueError(f"{name} kernel needs out fp32 [{B}, {out_rows}, {W}, {C}] on "
                         f"{x.device} with contiguous 16-byte aligned rows, images a multiple "
                         f"of 4 and at least {out_rows * row} elements apart, got {out.dtype} "
                         f"{tuple(out.shape)} strides {out.stride()} on {out.device}")


def _row_block_affine(x, out, out_rows: int, scale: float, shift: float, name: str):
    """row_block_affine of x into `out` [B, out_rows, W, C] (new, or as
    check_out allows) -> out."""
    B, H, W, C = x.shape
    _build.require(x, "x", torch.float32)
    row = W * C
    if row % 4:
        raise ValueError(f"{name} kernel needs W C % 4 == 0, got {tuple(x.shape)}")
    _build.check(_build.kernels().samroad_row_block_affine(
        x.data_ptr(), out.data_ptr(), B, H, out_rows, row, out.stride(0), scale, shift,
        _build.stream_of(x)), name)
    _build.launches[name] += 1
    return out


def nondiv_read_write(x, win: int = WIN):
    """T9: x [B, H, W, C] fp32 in blocks of win rows, the last partial; rows
    past H are 0, plus 1 -> [B, ceil(H / win) win, W, C]."""
    out_rows = -(-x.shape[1] // win) * win
    if _build.on_cpu(x):
        return row_block_affine_plain(x, out_rows, 1.0, 1.0)
    out = x.new_empty((x.shape[0], out_rows) + tuple(x.shape[2:]))
    return _row_block_affine(x, out, out_rows, 1.0, 1.0, "nondiv_read_write")


def nondiv_out_exact(x, win: int = WIN, out=None):
    """T10: 2 x, x [B, H, W, C] fp32, in blocks of win rows into an output of
    exactly H rows: a new tensor, or `out`, which may be a view of H rows of
    a taller buffer (the kernel writes nothing past row H). The blocks only
    say which rows exist, so win does not change the result."""
    if _build.on_cpu(x):
        y = row_block_affine_plain(x, x.shape[1], 2.0, 0.0)
        return y if out is None else out.copy_(y)
    if out is None:
        out = torch.empty_like(x)  # the cheapest allocation on the host (x must be contiguous)
    else:
        check_out(out, x, x.shape[1], "nondiv_out_exact")
    return _row_block_affine(x, out, x.shape[1], 2.0, 0.0, "nondiv_out_exact")


def window_colsum_plain(x, win: int):
    """out[b, r, j] = the sum of x[b, r, j win : (j + 1) win] over the W
    columns zero-padded to nJ win, x [B, R, W, C] -> [B, R, nJ, C]: the
    Pallas bodies of probe_inkernel_pad_loop and
    probe_oversized_sublane_block."""
    B, R, W, C = x.shape
    nJ = -(-W // win)
    xp = torch.nn.functional.pad(x, (0, 0, 0, nJ * win - W))
    return xp.reshape(B, R, nJ, win, C).sum(3)


def _window_colsum(x, win: int, staged: bool, name: str):
    B, R, W, C = x.shape
    _build.require(x, "x", torch.float32)
    out = x.new_empty((B, R, -(-W // win), C))
    _build.check(_build.kernels().samroad_window_colsum(
        x.data_ptr(), out.data_ptr(), B, R, W, C, win, int(staged), _build.stream_of(x)), name)
    _build.launches[name] += 1
    return out


def inkernel_pad_loop(x, win: int = WIN):
    """T11: the window-column sums of x [B, R, W, C] fp32 from a staged
    copy of each row zero-padded to nJ win columns."""
    if _build.on_cpu(x):
        return window_colsum_plain(x, win)
    return _window_colsum(x, win, True, "inkernel_pad_loop")


def oversized_sublane_block(x, win: int = WIN):
    """T12: T11's sums read from global memory at the unaligned starts j win
    through a column mask; bit-equal to T11."""
    if _build.on_cpu(x):
        return window_colsum_plain(x, win)
    return _window_colsum(x, win, False, "oversized_sublane_block")


def _inputs(seed: int, shape, dev):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).to(dev)


def _probe(key: str, kern, ref, tol: float, reps: int, dev):
    """kern() once, its max error against ref and the verdict, then its time
    over reps calls; a failure to build or launch is the probe's False.
    Returns the results and the first output (None after a failure)."""
    res, got = {key: False}, None
    try:
        got = kern()
        err = (got - ref).abs().max().item()
        res[key + "_max_err"] = err
        res[key] = err <= tol and bool(torch.isfinite(got).all())
        res[key + "_ms"] = ms_per_call(kern, reps, dev)
    except Exception as e:  # recorded, as the JAX probe records a lowering error
        print(f"# {key}: FAILED -> {type(e).__name__} {str(e)[:200]}", flush=True)
    return res, got


def probe_nondiv_read_write(device="cuda", *, batch: int = 2, rows: int = 32, width: int = 32,
                            channels: int = 256, win: int = WIN, reps: int = 20) -> dict:
    """Q1 / Q2 (T9): blocks of win rows over `rows`, the last partial."""
    dev = torch.device(device)
    x = _inputs(0, (batch, rows, width, channels), dev)
    out_rows = -(-rows // win) * win
    res, got = _probe("nondiv_read", lambda: nondiv_read_write(x, win),
                      row_block_affine_plain(x, out_rows, 1.0, 1.0), 0.0, reps, dev)
    if res["nondiv_read"]:
        pad = got[:, rows:]
        print(f"Q1 nondiv-leading-dim blocks build+run: OK (out shape "
              f"{(batch, out_rows, width, channels)})")
        print(f"Q2 real-region correct: True; pad-region rows contain: min "
              f"{pad.min().item():.3f} max {pad.max().item():.3f} (1.0 everywhere = rows past H "
              f"never read, 0 + 1)")
    else:
        print(f"Q1 NONDIV READ: WRONG (max err {res.get('nondiv_read_max_err')})")
    return res


def probe_nondiv_out_exact(device="cuda", *, batch: int = 2, rows: int = 32, width: int = 32,
                           channels: int = 256, win: int = WIN, reps: int = 20) -> dict:
    """Q3 (T10): an output of exactly H rows written in blocks of win; the
    kernel writes through a view of H rows of a buffer with GUARD_ROWS NaN
    rows past H in each image, which must stay NaN."""
    dev = torch.device(device)
    x = _inputs(1, (batch, rows, width, channels), dev)
    buf = torch.full((batch, rows + GUARD_ROWS, width, channels), math.nan, device=dev)
    view = buf[:, :rows]
    res, _ = _probe("oob_write", lambda: nondiv_out_exact(x, win, out=view),
                    row_block_affine_plain(x, rows, 2.0, 0.0), 0.0, reps, dev)
    guard = bool(torch.isnan(buf[:, rows:]).all())
    res["oob_write"] = res["oob_write"] and guard
    print(f"Q3 exact-size output with OOB write blocks: {'OK' if res['oob_write'] else 'WRONG'} "
          f"(max err {res.get('oob_write_max_err', math.nan):.2e}; the {GUARD_ROWS} guard rows "
          f"past H still NaN: {guard})")
    return res


def probe_inkernel_pad_loop(device="cuda", *, batch: int = 2, width: int = 32,
                            channels: int = 256, win: int = WIN, reps: int = 20) -> dict:
    """Q4 (T11): each row zero-padded to nJ win columns in shared memory,
    then a loop over the nJ window columns."""
    dev = torch.device(device)
    x = _inputs(2, (batch, win, width, channels), dev)
    res, _ = _probe("pad_loop", lambda: inkernel_pad_loop(x, win), window_colsum_plain(x, win),
                    SUM_TOL, reps, dev)
    print(f"Q4 staged zero-padded row + loop over window columns: "
          f"{'OK' if res['pad_loop'] else 'WRONG'} (max err "
          f"{res.get('pad_loop_max_err', math.nan):.2e})")
    return res


def probe_oversized_sublane_block(device="cuda", *, batch: int = 2, width: int = 32,
                                  channels: int = 256, win: int = WIN, reps: int = 20) -> dict:
    """Q5 / Q6 (T12): the window sums read at unaligned starts j win, the
    columns past W masked (never read)."""
    dev = torch.device(device)
    x = _inputs(3, (batch, win, width, channels), dev)
    res, _ = _probe("oversized_block", lambda: oversized_sublane_block(x, win),
                    window_colsum_plain(x, win), SUM_TOL, reps, dev)
    print(f"Q5/Q6 masked reads past W + unaligned starts j*{win}: "
          f"{'OK' if res['oversized_block'] else 'WRONG'} (max err "
          f"{res.get('oversized_block_max_err', math.nan):.2e})")
    return res


def main(device: str = "cuda", *, batch: int = 2, rows: int = 32, width: int = 32,
         channels: int = 256, win: int = WIN, reps: int = 20) -> dict:
    """Runs Q1-Q4 as the JAX script's __main__ does; returns and prints
    {"nondiv_read", "oob_write", "pad_loop"} and each key's _ms and
    _max_err. The geometry arguments exist so that a test can run the tool
    small."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to run the plain versions")
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    geo = dict(batch=batch, width=width, channels=channels, win=win, reps=reps)
    res = {**probe_nondiv_read_write(dev, rows=rows, **geo),
           **probe_nondiv_out_exact(dev, rows=rows, **geo),
           **probe_inkernel_pad_loop(dev, **geo)}
    print("VERDICT:", {k: res[k] for k in ("nondiv_read", "oob_write", "pad_loop")})
    print(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    main(ap.parse_args().device)
