"""Work counted from a configuration's shapes, and the card's peaks.

A matrix product of [M, K] by [K, N] is 2 M N K operations. Every count is
of the work the inputs need, whatever implements it: windowed attention
counts the real tokens' queries against a whole window of keys (the zero
padding's keys take part in the softmax), and nothing that an
implementation repeats (a recompute in a backward pass) is counted twice.
Bytes count each input read once and each output written once.

The peaks are copied from chip_smoke.py (PEAK_FLOPS, PEAK_BYTES): NVIDIA's
data sheet for the H100 SXM, dense bf16 and HBM3.
"""

from __future__ import annotations

import math

PEAK_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA's data sheet)
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
BF16 = 2


def _grid(arch) -> int:
    return arch["PATCH_SIZE"] // arch["patch_size"]


def _windows(arch) -> int:
    g, ws = _grid(arch), arch["window_size"]
    return math.ceil(g / ws) ** 2


def attention_flops(arch, kind: str) -> float:
    """Forward operations of one block's attention products for one patch:
    q.k and p.v over every head, and the decomposed rel-pos bias (q against
    the row and column tables). kind is "window" or "global"."""
    g, C = _grid(arch), arch["embed_dim"]
    T = g * g
    keys, side = (arch["window_size"] ** 2, arch["window_size"]) if kind == "window" else (T, g)
    return 4.0 * T * keys * C + 4.0 * T * side * C


def attention_bytes(arch, kind: str, backward: bool = False) -> float:
    """Bytes of one block's attention for one patch in bf16. Forward: q and
    the output over the real tokens, k and v over every key (the windows'
    padding included). Backward: q, the output's gradient and q's gradient
    over the real tokens, k, v and their gradients over every key."""
    g, C = _grid(arch), arch["embed_dim"]
    T = g * g
    keys = _windows(arch) * arch["window_size"] ** 2 if kind == "window" else T
    return BF16 * C * ((3 * T + 4 * keys) if backward else (2 * T + 2 * keys))


def encoder_flops(arch) -> float:
    """The image encoder's forward for one patch: patch embedding, every
    block's projections, MLP and attention, and the neck."""
    g, C, p = _grid(arch), arch["embed_dim"], arch["patch_size"]
    T, out = g * g, arch["out_chans"]
    mlp = int(C * arch["mlp_ratio"])
    n_global = len(arch["global_attn_indexes"])
    blocks = arch["depth"] * 2.0 * T * C * (3 * C + C + 2 * mlp)
    attn = (n_global * attention_flops(arch, "global")
            + (arch["depth"] - n_global) * attention_flops(arch, "window"))
    neck = 2.0 * T * C * out + 2.0 * T * out * out * 9
    return 2.0 * T * C * 3 * p * p + blocks + attn + neck


def encoder_params(arch) -> int:
    """The encoder's parameter count."""
    g, C, p = _grid(arch), arch["embed_dim"], arch["patch_size"]
    hd = C // arch["num_heads"]
    mlp = int(C * arch["mlp_ratio"])
    out = arch["out_chans"]
    n = g * g * C + C * 3 * p * p + C + C * out + out * out * 9 + 4 * out
    for i in range(arch["depth"]):
        size = g if i in arch["global_attn_indexes"] else arch["window_size"]
        n += 4 * C + 2 * (2 * size - 1) * hd + 3 * C * C + 3 * C + C * C + C
        n += 2 * C * mlp + mlp + C
    return n


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
