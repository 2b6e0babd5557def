"""The device trace of a traced segment, reduced to what the per-layer
metrics read: the device's busy seconds, its operations by name, its idle
gaps by what the host was doing, and each annotated span's device seconds.

An annotated span is a torch.profiler.record_function that the benchmark
puts around a call into a layer, or an autograd node of the program such
as _FusedAttentionBackward. Its device seconds: the span's kernels that
the trace links to a host op inside it (a kernel's linked correlation id)
mark where the span's work starts and ends on its stream, and every kernel
of that stream between them counts. One host thread launches a span's
work in order onto one stream, so nothing else runs there in between; and
the program's own kernels, launched through ctypes, link to no host op,
so only this way do they count at all.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time

import torch


@contextlib.contextmanager
def traced(device):
    """Profile CPU and CUDA activity; yields a dict that holds, after the
    block, the profiler ("prof") and the host seconds of the block
    ("window_s"), which ends once `device` has finished."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield out
        if on_card:
            torch.cuda.synchronize(device)
        out["window_s"] = time.perf_counter() - t0
    out["prof"] = prof


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(prof, window_s: float, spans=(), kernels=()) -> dict:
    """busy_s (union of device activity), window_s, the ten device ops of
    most total seconds, the ten longest idle gaps named by the innermost host
    op running at their middle, for each name in `spans` the device seconds
    of the spans of that name (a name matches a host op whose name contains
    it), and for each name in `kernels` the seconds of the device ops whose
    name contains it."""
    events = prof.profiler.kineto_results.events()
    cpu, gpu = [], []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CPU:
            cpu.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                        e.start_thread_id(), e.correlation_id()))
        elif not e.is_user_annotation():  # not the device's copy of a host span
            gpu.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                        e.linked_correlation_id(), e.device_resource_id()))
    if not gpu:
        return {"busy_s": 0.0, "window_s": window_s, "device_ops": [], "idle_gaps": [],
                "spans": {}, "kernels": {}}
    busy = _union([(g[0], g[1]) for g in gpu])
    busy_s = sum(e - s for s, e in busy) * 1e-9
    by_name: dict = {}
    for s, e, name, *_ in gpu:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-9
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    main = collections.Counter(c[3] for c in cpu).most_common(1)[0][0] if cpu else None
    host = sorted((c for c in cpu if c[3] == main), key=lambda c: c[0])
    gap_list = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                      reverse=True)[:10]
    starts = [c[0] for c in host]
    idle = []
    for dur, g0, g1 in gap_list:
        mid = (g0 + g1) // 2
        name, depth = "host code outside any op", -1
        for c in host[:bisect.bisect_right(starts, mid)]:
            if c[1] >= mid and c[0] > depth:
                name, depth = c[2], c[0]
        idle.append([name, dur * 1e-9])

    by_corr = {c[4]: c for c in cpu}
    streams: dict = {}
    for g in sorted(gpu):
        streams.setdefault(g[4], []).append(g)
    starts_of = {k: [g[0] for g in v] for k, v in streams.items()}
    span_dev = {}
    for want in spans:
        ranges: dict = {}
        for c in cpu:
            if want in c[2]:
                ranges.setdefault(c[3], []).append((c[0], c[1]))
        if not ranges:
            continue
        ranges = {t: _union(r) for t, r in ranges.items()}
        marks: dict = {}  # (thread, range index) -> [stream, first start, last end]
        for s, e, _, link, stream in gpu:
            op = by_corr.get(link)
            r = ranges.get(op[3]) if op is not None else None
            if not r:
                continue
            i = bisect.bisect_right(r, [op[0], float("inf")]) - 1
            if i >= 0 and r[i][0] <= op[0] <= r[i][1]:
                m = marks.setdefault((op[3], i), [stream, s, e])
                m[1], m[2] = min(m[1], s), max(m[2], e)
        total = 0.0
        for stream, lo, hi in marks.values():
            events = streams[stream]
            j = bisect.bisect_left(starts_of[stream], lo)
            while j < len(events) and events[j][0] < hi:
                total += (min(events[j][1], hi) - events[j][0]) * 1e-9
                j += 1
        span_dev[want] = total
    kernel_dev = {want: sum(v for n, v in by_name.items() if want in n) for want in kernels}
    return {"busy_s": busy_s, "window_s": window_s, "device_ops": device_ops,
            "idle_gaps": idle, "spans": span_dev, "kernels": kernel_dev}
