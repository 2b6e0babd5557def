"""Host seconds of the edge aggregation a region: the engine's span
engine.aggregate over _aggregate_edges (the exact int64 averages of every
directed pair's scores and the TOPO_THRESHOLD cut), last_timings["aggregate"],
averaged over the window's regions."""

from benchmark.region_timings import mean


def read(run):
    return mean(run, "aggregate")
