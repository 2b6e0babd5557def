"""Trace capture (counterpart of sam_road_tpu/utils/profiling.py's
maybe_trace, over torch.profiler instead of jax.profiler), the program's
spans, and the per-call timer of the port's tools. Importing it imports no
torch: host-only modules (graph/) hold spans too."""

from __future__ import annotations

import contextlib
import os
import sys
import time


def _profiling() -> bool:
    """Whether a torch.profiler is recording in this process (none can be
    where torch was never imported)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


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


class span:
    """A named host span of the program: `with span(name, into, key) as s`.

    Always times the block by time.perf_counter: `s.seconds` after it, and
    added into `into[key]` where `into` is given (a key's spans add up).
    While a torch.profiler is active (maybe_trace, or any caller's
    profile()), the block is also a record_function(name) range, so it lies
    in the trace on the clock of the card's kernels, nested under the
    spans around it. With no profiler active it costs two clock reads and
    one flag check."""

    __slots__ = ("name", "into", "key", "seconds", "_t0", "_range")

    def __init__(self, name: str, into: dict | None = None, key: str | None = None):
        self.name, self.into, self.key = name, into, key
        self.seconds = 0.0

    def __enter__(self):
        self._range = None
        if _profiling():
            from torch.profiler import record_function

            self._range = record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self.into is not None:
            self.into[self.key] = self.into.get(self.key, 0.0) + self.seconds
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


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
