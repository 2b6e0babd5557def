"""The training step's seconds, by the host's clock: the untraced window's
seconds over the Trainer.train_epoch steps it completed, each ending in the
loss's copy to the host. The window is all the work and all the time; a
stall in it counts.

The step is host-bound (vit_h at 4 x 256 px launches thousands of small
kernels a step), so it follows the host's speed, which a shared host varies
from run to run by more than any end-to-end bound may allow; it is reported
here, per layer, with no bound (PERF.md, section 2)."""


def read(run):
    if run["kind"] != "train" or not run["units"]:
        return None
    return run["window_s"] / run["units"]
