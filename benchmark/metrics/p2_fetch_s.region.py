"""Host seconds a region blocked on TopoNet's scores: the engine's span
engine.p2.fetch (the stacked copies to the host), last_timings["p2_fetch"],
averaged over the window's regions (a region without vertices counts 0).
Near 0 while the host paces the card."""

from benchmark.region_timings import mean


def read(run):
    return mean(run, "p2_fetch", missing=0.0)
