"""K5's share of its roofline in the traced regions, in %: the eager
encoder's attention (models/vit.py's fused_attention, relpos_attention.cu
in its folded mode), every windowed and global block.

Work: for each encoder call on b patches and each block, the forward's
operations (benchmark/counts.py::attention_flops: q.k, p.v and the rel-pos
tables over every head, the real tokens against every key of their
window) and bytes (q, k, v read and the output written in bf16,
attention_bytes) times b; each call's least time is the larger of
operations at 989 TFLOP/s and bytes at 3.35 TB/s. The rel-pos tables'
products (3-7 % of the operations at ViT-B 512 px) are folded into q and k
outside K5, as in attention_roofline.train.
Time: the device seconds of the kernels named relpos_attention_kernel.
Nothing where the trace shows none, or where it shows the fused encoder's
window_attention_kernel (K2): its global blocks' K3 shares K5's name."""

from benchmark import counts


def read(run):
    t = run.get("trace")
    if run["kind"] != "region" or not t:
        return None
    dev = t["kernels"].get("relpos_attention_kernel")
    if not dev or t["kernels"].get("window_attention_kernel"):
        return None
    arch = run["arch"]
    bound = 0.0
    for kind, n in counts.attention_blocks(arch).items():
        f, nbytes = counts.attention_flops(arch, kind), counts.attention_bytes(arch, kind)
        bound += n * sum(counts.roofline_s(b * f, b * nbytes) for b in t["encoder_batches"])
    return 100.0 * bound / dev
