"""The whole training step's share of the card's bf16 peak, in %: three
times the forward's operations (forward and backward) of a step over
step_s.train (the window's seconds over its steps), at 989 TFLOP/s.

Forward operations (benchmark/counts.py): the encoder and the map decoder
over the batch's patches, and TopoNet over each patch's points and its
TOPO_SAMPLE_NUM x MAX_NEIGHBOR_QUERIES pairs, as the batches' shapes give
them, averaged over the window's cycle of batches."""

from benchmark import counts


def read(run):
    if run["kind"] != "train" or not run["units"]:
        return None
    arch = run["arch"]
    per_patch = counts.encoder_flops(arch) + counts.decoder_flops(arch)
    fwd = 0.0
    for b in run["batches"]:
        B, P = b["graph_points"].shape[:2]
        _, S, K = b["valid"].shape
        fwd += B * per_patch + B * counts.toponet_flops(arch, P, S * K, K)
    fwd /= len(run["batches"])
    step_s = run["window_s"] / run["units"]
    return 100.0 * 3.0 * fwd / step_s / counts.PEAK_FLOPS
