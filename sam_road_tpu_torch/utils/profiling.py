"""Trace capture (counterpart of sam_road_tpu/utils/profiling.py's
maybe_trace, over torch.profiler instead of jax.profiler)."""

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
