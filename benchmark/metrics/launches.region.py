"""The port's hand-written kernel launches a region: ops/_build.py's
launches counter over the region's _run_phase1 and _finish,
last_timings["launches"], averaged over the window's regions. A count: K1-K4
over phase 1's batches under the fused encoder, K5 under the eager one; 0
where the plain versions run."""

from benchmark.region_timings import mean


def read(run):
    return mean(run, "launches")
