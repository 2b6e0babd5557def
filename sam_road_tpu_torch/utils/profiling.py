"""Trace capture (counterpart of sam_road_tpu/utils/profiling.py's
maybe_trace, over torch.profiler instead of jax.profiler), and the per-call
timer of the port's tools."""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None):
    """With trace_dir set, profile the block (CPU, and CUDA where a GPU is
    present) and write a Chrome trace to <trace_dir>/trace_<ns>.json,
    viewable in Perfetto; with it empty, do nothing."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{time.time_ns()}.json"))


def ms_per_call(fn, calls: int, device) -> float:
    """Milliseconds per call of fn() over `calls` calls in a row: CUDA
    events around them on a CUDA device, the host clock on the CPU."""
    import torch

    if torch.device(device).type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) * 1e3 / calls
