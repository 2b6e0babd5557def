"""K5's share of its roofline in the traced training steps, in %: the
encoder's attention (models/vit.py's fused_attention), forward and
backward.

Work: for each block and step, the forward's operations
(benchmark/counts.py::attention_flops: q.k, p.v and the rel-pos tables
over every head, the real tokens against every key of their window) times
B, and twice that for the backward; bytes: q, k, v read and the output
written in bf16 forward, and q, k, v and the output's gradient read and
the three gradients written backward. Each call's least time is the larger
of operations at 989 TFLOP/s and bytes at 3.35 TB/s.
Time: the forward's K5 kernels by name (relpos_attention_kernel in its
folded mode, the only one training runs, and folded_attention_f32), plus
the device seconds of the spans of the program's _FusedAttentionBackward
autograd nodes (benchmark/trace.py). Nothing when the trace shows neither."""

from benchmark import counts


def read(run):
    t = run.get("trace")
    if run["kind"] != "train" or not t:
        return None
    forward = sum(t["kernels"].values())
    backward = t["spans"].get("_FusedAttentionBackward", 0.0)
    if not forward or not backward:
        return None
    dev = forward + backward
    arch = run["arch"]
    B = int(run["cfg"]["BATCH_SIZE"])
    bound = 0.0
    for kind, n in counts.attention_blocks(arch).items():
        f = counts.attention_flops(arch, kind)
        fwd, bwd = counts.attention_bytes(arch, kind), counts.attention_bytes(arch, kind, True)
        bound += n * (counts.roofline_s(B * f, B * fwd) + counts.roofline_s(2 * B * f, B * bwd))
    return 100.0 * bound * t["units"] / dev
