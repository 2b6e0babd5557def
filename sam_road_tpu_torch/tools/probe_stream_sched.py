"""The streamed phase 1's schedule on the bench region, step by step
(counterpart of the repository's tools/probe_stream_sched.py).

The default config streams phase 1 (inference/engine.py::_phase1_streamed:
INFER_STREAM_BANDS tapered column bands over `_stream_plan`'s split). This
tool runs that path itself, `_run_phase1` and then `_finish`, with its
steps wrapped on the probe's engine instance so that each records a
timestamp: the slab uploads (`_Uploads.put`), the host's waits for them
(`_Uploads.wait`: under INFER_STREAM_SERIAL_UPLOAD, the default, slab 0 is
sent and waited for first and slab i + 1 is sent and waited for after band
i; without it every slab is sent before band 0), each band's pixels
(`_band_pixels`), its batches and finalisation (`_stream_band`, whose
chunk's copy to the host then starts), and the reads of the chunks' host
copies (`_HostCopy.numpy`, in `_finish` or, with INFER_P2_SPECULATIVE, in
`_speculate_phase2`). Per run:
  slab_disp[i]    host s when slab i's upload call returned (its copy runs
                  on the engine's copy stream)
  slab_wait_s[i]  host s spent waiting for slab i to land (0 where the
                  schedule does not wait)
  slab_ready[i]   device s when slab i had landed: an event recorded on the
                  copy stream after the copy
  band_disp[i]    host s when band i's batches and finalisation had been
                  dispatched
  chunk_ready[i]  device s when band i's uint8 chunk was final: an event on
                  the compute stream after `_finalize`
  fetch_done[i]   host s when chunk i's host copy was read, in order
  seg_slice_s[i]  host s of band i's pixel assembly
  p1_wall         host s when the last chunk was read
  engine_timings  `last_timings` of the `_finish`
  total           host s to the end of `_finish`
Host times count from t0, the host clock when the run starts. Device times
are CUDA events read against a start event recorded on the compute stream
at t0, so their zero is when the stream reached t0's point, not the host's
t0 (on the CPU, which has no streams, they are host times at the same
points). Every round runs a plain `infer_one_img` and then the
instrumented run, whose nodes, edges and masks must equal the plain run's
bit for bit (`same_outputs`). Thresholds come from `bench.calibrate`.

    python -m sam_road_tpu_torch.tools.probe_stream_sched [--rounds 3] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from sam_road_tpu_torch.tools import bench


class Clock:
    """Host seconds from t0 and device seconds from a start event recorded
    at t0 on the compute stream (host seconds at the mark on the CPU)."""

    def __init__(self, dev):
        import torch

        self.cuda = dev.type == "cuda"
        self.t0 = time.perf_counter()
        self.start = None
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(torch.cuda.current_stream(dev))

    def host(self) -> float:
        return time.perf_counter() - self.t0

    def mark(self, stream=None):
        """An event recorded on `stream` (the current stream by default), or
        the host time on the CPU."""
        import torch

        if not self.cuda:
            return self.host()
        event = torch.cuda.Event(enable_timing=True)
        if stream is None:
            event.record()
        else:
            event.record(stream)
        return event

    def read(self, mark) -> float:
        """A mark's seconds from the start, once it has completed."""
        if not self.cuda:
            return mark
        mark.synchronize()
        return self.start.elapsed_time(mark) / 1e3


def instrumented_run(engine, img) -> tuple:
    """`_run_phase1` and `_finish` on `engine`, its streamed steps wrapped
    with timestamps for the run. Returns (the record, `_finish`'s
    outputs)."""
    clock = Clock(engine.device)
    rec = dict(slab_disp=[], slab_wait_s=[], slab_ready=[], band_disp=[], chunk_ready=[],
               fetch_done=[], seg_slice_s=[])
    slab_marks, chunk_marks, slab_of = [], [], {}
    uploads = engine.uploads

    put0, wait0 = uploads.put, uploads.wait
    band_pixels0, stream_band0 = engine._band_pixels, engine._stream_band
    speculate0 = engine._speculate_phase2

    def put(a):
        upload = put0(a)
        rec["slab_disp"].append(clock.host())
        slab_marks.append(clock.mark(uploads.stream))
        slab_of[id(upload)] = len(rec["slab_wait_s"])
        rec["slab_wait_s"].append(0.0)
        return upload

    def wait(upload):
        t = time.perf_counter()
        wait0(upload)
        rec["slab_wait_s"][slab_of[id(upload)]] += time.perf_counter() - t

    def band_pixels(*args):
        t = time.perf_counter()
        out = band_pixels0(*args)
        rec["seg_slice_s"].append(time.perf_counter() - t)
        return out

    def stream_band(*args):
        out = stream_band0(*args)
        rec["band_disp"].append(clock.host())
        chunk_marks.append(clock.mark())
        return out

    def timed(copies):
        for c in copies:
            if "numpy" not in vars(c):
                c.numpy = read(c.numpy)
        return copies

    def read(numpy):
        def stamped():
            out = numpy()
            rec["fetch_done"].append(clock.host())
            rec["p1_wall"] = rec["fetch_done"][-1]
            return out
        return stamped

    def speculate(plan, batches, copies):
        return speculate0(plan, batches, timed(copies))

    steps = {"_band_pixels": band_pixels, "_stream_band": stream_band,
             "_speculate_phase2": speculate}
    vars(engine).update(steps)
    uploads.put, uploads.wait = put, wait
    try:
        p1 = engine._run_phase1(img)
        if p1["plan"] is None:
            raise ValueError("the engine did not stream phase 1")
        timed(p1["copies"])
        out = engine._finish(p1)
        rec["total"] = clock.host()
    finally:
        for name in steps:
            vars(engine).pop(name)
        del uploads.put, uploads.wait
    rec["slab_ready"] = [clock.read(m) for m in slab_marks]
    rec["chunk_ready"] = [clock.read(m) for m in chunk_marks]
    rec["engine_timings"] = dict(engine.last_timings)
    return rec, out


def same_outputs(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b, strict=True))


def stream_plan(engine, size: int):
    """The region's patches and the engine's streamed plan for them."""
    from sam_road_tpu_torch.data.partitions import get_patch_info_one_img

    cfg = engine.config
    infos = get_patch_info_one_img(0, size, cfg.SAMPLE_MARGIN, engine.patch_size,
                                   cfg.INFER_PATCHES_PER_EDGE)
    plan = engine._stream_plan(infos, size, int(cfg.INFER_STREAM_BANDS or 2))
    if plan is None or not bool(cfg.INFER_STREAM_PHASE1):
        raise ValueError("the engine does not stream phase 1 at this geometry")
    return infos, plan


def main(device: str = "cuda", *, rounds: int = 3, model=None,
         overrides: dict | None = None, region: np.ndarray | None = None,
         seed: int = bench.SEED) -> list:
    """Prints one JSON line a round ({round, plain_total, plain_timings,
    instr, same_outputs}) and returns them. `model`, `overrides` (on top of
    the bench config) and `region` exist so that a test can run the tool
    small."""
    import torch

    dev = bench.require_device(device)
    engine = bench.make_engine(dev, overrides, model, seed)
    img = bench.make_region() if region is None else region
    _, plan = stream_plan(engine, img.shape[0])
    rows = []
    with torch.no_grad():
        bench.calibrate(engine, img)
        engine.infer_one_img(img)  # the workload, warm
        for r in range(rounds):
            bench.sync(dev)
            t = time.perf_counter()
            plain = engine.infer_one_img(img)
            plain_total = time.perf_counter() - t
            plain_timings = dict(engine.last_timings)
            bench.sync(dev)
            rec, out = instrumented_run(engine, img)
            row = {"round": r, "plain_total": plain_total, "plain_timings": plain_timings,
                   "instr": rec, "same_outputs": same_outputs(plain, out),
                   "bands": [[b["a"], b["e"]] for b in plan]}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args()
    main(args.device, rounds=args.rounds)
