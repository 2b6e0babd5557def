"""Work counted from a configuration's shapes, and the card's peaks.

A matrix product of [M, K] by [K, N] is 2 M N K operations. Every count is
of the work the inputs need, whatever implements it: windowed attention
counts the real tokens' queries against a whole window of keys (the zero
padding's keys take part in the softmax), and nothing that an
implementation repeats (a recompute in a backward pass) is counted twice.
Bytes count each input read once and each output written once. The image
encoder's counts are its family's (benchmark/reference/encoders/).

The peaks are copied from chip_smoke.py (PEAK_FLOPS, PEAK_BYTES): NVIDIA's
data sheet for the H100 SXM, dense bf16 and HBM3.
"""

from __future__ import annotations

from benchmark.reference.encoders import family

PEAK_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA's data sheet)
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
BF16 = 2


def _grid(arch) -> int:
    return family(arch).grid(arch)


def attention_blocks(arch) -> dict:
    """How many blocks the encoder has of each attention kind."""
    return family(arch).attention_blocks(arch)


def attention_flops(arch, kind: str) -> float:
    """Forward operations of one block's attention of `kind` for one patch."""
    return family(arch).attention_flops(arch, kind)


def attention_bytes(arch, kind: str, backward: bool = False) -> float:
    """Bytes of one block's attention of `kind` for one patch in bf16."""
    return family(arch).attention_bytes(arch, kind, backward)


def encoder_flops(arch) -> float:
    """The image encoder's forward for one patch (the family's count)."""
    return family(arch).flops(arch)


def encoder_params(arch) -> int:
    """The encoder's parameter count."""
    return family(arch).params(arch)


def encoder_call_bytes(arch, batch: int) -> float:
    """One encoder call on `batch` patches: its float32 parameters read
    once, the bf16 input image and the bf16 embeddings written."""
    P, g = arch["PATCH_SIZE"], _grid(arch)
    return 4.0 * encoder_params(arch) + BF16 * batch * (P * P * 3 + g * g * arch["out_chans"])


def decoder_flops(arch) -> float:
    """The map decoder for one patch: four 2x2 stride-2 transposed
    convolutions, 256 -> 128 -> 64 -> 32 -> 2 channels."""
    g = _grid(arch)
    chans = (arch["out_chans"], 128, 64, 32, 2)
    total, pix = 0.0, g * g
    for a, b in zip(chans, chans[1:]):
        total += 2.0 * pix * a * 4 * b
        pix *= 4
    return total


def toponet_flops(arch, points: int, pairs: int, k: int) -> float:
    """TopoNet on `points` sampled points and `pairs` pairs in groups of k:
    the point projection, the pair projection, each encoder layer's
    projections, attention within a group and feed-forward, the output."""
    h, feat = arch["topo_hidden"], arch["out_chans"]
    layer = 2.0 * pairs * h * (3 * h + h + h + h) + 4.0 * pairs * k * h
    return (2.0 * points * feat * h + 2.0 * pairs * (2 * h + 2) * h
            + arch["topo_layers"] * layer + 2.0 * pairs * h)


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the bf16 peak or
    bytes at the HBM peak, whichever is longer."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
