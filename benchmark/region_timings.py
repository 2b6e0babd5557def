"""The mean over a region run's window of one key of the engine's
last_timings (inference/engine.py), for the per-layer metrics that read
the program's own spans and counters."""


def mean(run, key: str, missing=None):
    """The mean of last_timings[key] over the window's regions. A region
    without the key counts `missing`; with `missing` None, such a region
    (a program that does not report the key) makes the metric None, as
    does a run that is not a region run."""
    if run["kind"] != "region" or not run["timings"]:
        return None
    values = [t.get(key, missing) for t in run["timings"]]
    if any(v is None for v in values):
        return None
    return sum(values) / len(values)
