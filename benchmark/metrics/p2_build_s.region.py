"""Host seconds of phase 2's pair building a region (the engine's
_build_args over inference/pairs.py's native kNN): the program's own
clock, last_timings["p2_build"], averaged over the window's regions (a
region without vertices has no phase 2 and counts 0)."""


def read(run):
    if run["kind"] != "region" or not run["timings"]:
        return None
    return sum(t.get("p2_build", 0.0) for t in run["timings"]) / len(run["timings"])
