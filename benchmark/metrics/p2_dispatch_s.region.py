"""Host seconds of phase 2's dispatch a region: the engine's spans
engine.p2.dispatch (the uploads of the compact arguments and TopoNet's
launches), last_timings["p2_dispatch"], averaged over the window's regions
(a region without vertices has no phase 2 and counts 0)."""

from benchmark.region_timings import mean


def read(run):
    return mean(run, "p2_dispatch", missing=0.0)
