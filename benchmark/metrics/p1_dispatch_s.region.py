"""Host seconds of phase 1's dispatch a region: the engine's span
engine.phase1 over _run_phase1 (the batch loop that enqueues the crops, the
fused encoder, the decoder and the mask fusion), last_timings["p1_dispatch"],
averaged over the window's regions."""

from benchmark.region_timings import mean


def read(run):
    return mean(run, "p1_dispatch")
