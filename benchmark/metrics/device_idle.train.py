"""The share of the window in which no operation ran on the card, in %:
1 - (device busy seconds a unit, from the traced training steps) / (seconds a
unit of the untraced window). busy_s is the union of every kernel, copy
and fill in torch.profiler's device trace. The traced segment's own length
is not the denominator: tracing slows the host's side of each unit and
leaves the card idle longer than the untraced program does."""


def read(run):
    t = run.get("trace")
    if run["kind"] != "train" or not t or not t["busy_s"] or not run["units"]:
        return None
    return 100.0 * (1.0 - (t["busy_s"] / t["units"]) / (run["window_s"] / run["units"]))
