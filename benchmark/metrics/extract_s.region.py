"""Host seconds of vertex extraction a region (graph/extraction.py over the
native NMS): the program's own clock, last_timings["extract"], averaged
over the window's regions."""


def read(run):
    if run["kind"] != "region" or not run["timings"]:
        return None
    return sum(t["extract"] for t in run["timings"]) / len(run["timings"])
