"""The image encoder's share of its roofline in the traced regions, in %.

Work: per encoder call on b patches, the operations of b patches' forward
(benchmark/counts.py::encoder_flops, from the configuration's shapes) and
its bytes (float32 parameters read once, bf16 input and embeddings);
the call's least time is the larger of operations at 989 TFLOP/s and bytes
at 3.35 TB/s (operations bound it at every batch the cells use).
Time: the device seconds of every kernel launched inside the benchmark's
record_function("bench.encoder") around the encoder call: the engine's
fused encoder, or the model's own image_encoder where it runs eagerly.
Nothing when the trace attributes no kernel to that span."""

from benchmark import counts


def read(run):
    t = run.get("trace")
    if run["kind"] != "region" or not t or not t["spans"].get("bench.encoder"):
        return None
    arch = run["arch"]
    bound = sum(counts.roofline_s(b * counts.encoder_flops(arch),
                                  counts.encoder_call_bytes(arch, b))
                for b in t["encoder_batches"])
    return 100.0 * bound / t["spans"]["bench.encoder"]
