"""Seconds of phase 1 on the card a region: two CUDA events that the
engine records on its compute stream, before phase 1's first launch and
after its last mask chunk's copy is queued, last_timings["p1_device"],
averaged over the window's regions. The span on the stream includes its
stalls on the slab uploads and on the host's enqueue. None off CUDA."""

from benchmark.region_timings import mean


def read(run):
    return mean(run, "p1_device")
