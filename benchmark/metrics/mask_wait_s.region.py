"""Host seconds a region blocked on phase 1: the engine's span
engine.fetch_masks (the wait for the mask copies to the host),
last_timings["mask_wait"], averaged over the window's regions. Near 0
while the host paces the card."""

from benchmark.region_timings import mean


def read(run):
    return mean(run, "mask_wait")
