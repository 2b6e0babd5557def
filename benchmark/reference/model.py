"""SAM-Road's forward in plain PyTorch, written from the published models.

The image encoder is the configuration's family (encoders/, by
`published.encoder`; SAM's ViT where none is named). SAM-Road's naive map
decoder and TopoNet (github.com/htcr/sam_road, model.py: four stride-2
transposed convolutions; a point-feature projection, pair features [src,
tgt, tgt - src], a 3-layer post-norm nn.TransformerEncoder with ReLU and
dropout 0.1 inside each source point's group of pairs, one logit per pair),
and F.grid_sample's bilinear point sampling, are shared by every family.

Everything is a function of a state dict (SAM's torch names, which the
program under test also uses) and a configuration file's `published` block;
nothing here imports the program. Arithmetic is float32 with TF32 off,
unless a `Precision` other than FP32 is passed (the control): then every
tensor that a model computing in that precision holds in it is rounded to
it: each product's operands and result, each norm's and activation's
output, the residual stream, the attention scores of TopoNet, the pair
coordinates; reductions, norms and softmax compute in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import encoders

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


def _round_fp8(x, dtype):
    """x rounded to the float8 `dtype` after scaling its absolute maximum
    onto that type's largest finite value (per-tensor scaling)."""
    top = torch.finfo(dtype).max
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8(torch.autograd.Function):
    """Forward operands in e4m3, their gradients in e5m2, as fp8 training
    recipes round them."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2)


class Precision:
    """Rounds a tensor to the compute precision. FP32 leaves it alone; FP8
    rounds it to float8_e4m3fn, and its gradient to float8_e5m2, each
    scaled by its absolute maximum (per-tensor scaling)."""

    def __init__(self, name: str):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, x):
        return x if self.name == "fp32" else _Fp8.apply(x)


FP32 = Precision("fp32")


def tf32_off() -> None:
    """Plain float32 products on the card: TF32 would round their inputs
    to 10 mantissa bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------- weights


def param_specs(arch: dict) -> list:
    """(name, shape, init) of every parameter, in the program's state-dict
    order: the encoder family's, then the map decoder's and TopoNet's.
    init: "lecun" N(0, 1 / fan_in), "lecun_t" the same with a transposed
    convolution's fan-in, "table" N(0, 0.02^2), "one", "zero".
    `arch` is a configuration file's `published` block plus its PATCH_SIZE."""
    out = arch["out_chans"]
    specs = encoders.family(arch).param_specs(arch)
    chans = (out, 128, 64, 32, 2)
    for j, slot in enumerate((0, 3, 5, 7)):
        specs += [(f"map_decoder.{slot}.weight", (chans[j], chans[j + 1], 2, 2), "lecun_t"),
                  (f"map_decoder.{slot}.bias", (chans[j + 1],), "zero")]
        if slot == 0:
            specs += [("map_decoder.1.weight", (128,), "one"),
                      ("map_decoder.1.bias", (128,), "zero")]
    h = arch["topo_hidden"]
    specs += [("topo_net.feature_proj.weight", (h, out), "lecun"),
              ("topo_net.feature_proj.bias", (h,), "zero"),
              ("topo_net.pair_proj.weight", (h, 2 * h + 2), "lecun"),
              ("topo_net.pair_proj.bias", (h,), "zero")]
    for layer in range(arch["topo_layers"]):
        t = f"topo_net.transformer_encoder.layers.{layer}."
        specs += [(t + "self_attn.in_proj_weight", (3 * h, h), "lecun"),
                  (t + "self_attn.in_proj_bias", (3 * h,), "zero"),
                  (t + "self_attn.out_proj.weight", (h, h), "lecun"),
                  (t + "self_attn.out_proj.bias", (h,), "zero"),
                  (t + "linear1.weight", (h, h), "lecun"), (t + "linear1.bias", (h,), "zero"),
                  (t + "linear2.weight", (h, h), "lecun"), (t + "linear2.bias", (h,), "zero"),
                  (t + "norm1.weight", (h,), "one"), (t + "norm1.bias", (h,), "zero"),
                  (t + "norm2.weight", (h,), "one"), (t + "norm2.bias", (h,), "zero")]
    specs += [("topo_net.output_proj.weight", (1, h), "lecun"),
              ("topo_net.output_proj.bias", (1,), "zero")]
    return specs


@torch.no_grad()
def make_weights(arch: dict, seed: int, device) -> dict:
    """The state dict from `seed`, on `device`, in float32 (the program
    keeps float32 parameters and casts at use): one normal draw from a
    torch.Generator on the device for every random leaf together, each leaf
    a scaled view of it."""
    specs = param_specs(arch)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    n_rand = sum(math.prod(s) for _, s, k in specs if k in ("lecun", "lecun_t", "table"))
    draw = torch.randn(n_rand, generator=gen, device=device)
    sd, at = {}, 0
    for name, shape, kind in specs:
        n = math.prod(shape)
        if kind == "one":
            sd[name] = torch.ones(shape, device=device)
        elif kind == "zero":
            sd[name] = torch.zeros(shape, device=device)
        else:
            fan_in = shape[0] if kind == "lecun_t" else n // shape[0]
            std = 0.02 if kind == "table" else fan_in ** -0.5
            sd[name] = draw[at:at + n].view(shape).mul_(std)
            at += n
    return sd


# ---------------------------------------------------------------- shared layers


def _linear(x, sd, name, prec):
    return prec(F.linear(prec(x), prec(sd[name + ".weight"]), sd[name + ".bias"]))


def _ln(x, sd, name, eps, prec):
    return prec(F.layer_norm(x, x.shape[-1:], sd[name + ".weight"], sd[name + ".bias"], eps))


def _ln2d(x, sd, name, prec):
    """SAM's LayerNorm2d (eps 1e-6) over NCHW channels."""
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + 1e-6)
    return prec(sd[name + ".weight"][:, None, None] * x + sd[name + ".bias"][:, None, None])


def encoder(sd, rgb, arch, prec=FP32):
    """rgb [B, H, W, 3] in 0-255 -> embeddings [B, 256, H / 16, W / 16],
    through the configuration's encoder family."""
    return encoders.family(arch).forward(sd, rgb, arch, prec)


def decoder(sd, emb, prec=FP32):
    """The naive map decoder: [B, 256, h, w] -> logits [B, H, W, 2]
    (keypoint, road)."""
    x = emb
    for j, slot in enumerate((0, 3, 5, 7)):
        x = prec(F.conv_transpose2d(x, prec(sd[f"map_decoder.{slot}.weight"]),
                                    sd[f"map_decoder.{slot}.bias"], stride=2))
        if slot == 0:
            x = _ln2d(x, sd, "map_decoder.1", prec)
        if slot != 7:
            x = prec(F.gelu(x))
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------- TopoNet


def sample_points(emb, points, patch_size: int):
    """F.grid_sample (bilinear, align_corners False, zero padding) of
    emb [B, D, h, w] at (x, y) patch pixels points [B, N, 2] -> [B, N, D]."""
    grid = (points.float() / patch_size * 2.0 - 1.0)[:, :, None, :]
    out = F.grid_sample(emb, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
    return out[..., 0].permute(0, 2, 1)


def _dropout(x, gen):
    """Dropout at 0.1 with the keep mask drawn from `gen` (None: off)."""
    if gen is None:
        return x
    keep = torch.empty(x.shape, device=x.device).bernoulli_(0.9, generator=gen)
    return x * (keep / 0.9)


def _encoder_layer(x, sd, t, nh, pad, prec, gen):
    """nn.TransformerEncoderLayer (post-norm, ReLU, eps 1e-5) with a key
    padding mask `pad` [G, K]."""
    G, K, C = x.shape
    hd = C // nh
    qkv = prec(F.linear(x, prec(sd[t + "self_attn.in_proj_weight"]),
                        sd[t + "self_attn.in_proj_bias"]))
    q, k, v = (u.reshape(G, K, nh, hd).transpose(1, 2) for u in qkv.chunk(3, dim=-1))
    s = prec(prec(q / math.sqrt(hd)) @ k.transpose(-2, -1))
    s = s.masked_fill(pad[:, None, None, :], float("-inf")).softmax(dim=-1)
    a = prec(prec(s) @ v).transpose(1, 2).reshape(G, K, C)
    a = _linear(a, sd, t + "self_attn.out_proj", prec)
    x = _ln(x + _dropout(a, gen), sd, t + "norm1", 1e-5, prec)
    h = _dropout(prec(F.relu(_linear(x, sd, t + "linear1", prec))), gen)
    h = _dropout(_linear(h, sd, t + "linear2", prec), gen)
    return _ln(x + h, sd, t + "norm2", 1e-5, prec)


def toponet(sd, arch, points, feats, pairs, valid, prec=FP32, gen=None):
    """Edge logits [B, S, K] for pairs [B, S, K, 2] (indices into points
    [B, P, 2] and their features feats [B, P, 256]) under valid [B, S, K].
    A group with no valid pair attends to all of its pairs (the published
    model's guard against an all-masked softmax)."""
    pf = prec(F.relu(_linear(prec(feats), sd, "topo_net.feature_proj", prec)))
    B, S, K, _ = pairs.shape
    flat = pairs.reshape(B, S * K, 2).long()
    bi = torch.arange(B, device=pf.device)[:, None]
    src, tgt = flat[..., 0], flat[..., 1]
    pts = prec(points.float())
    off = prec(pts[bi, tgt] - pts[bi, src])
    x = torch.cat([pf[bi, src], pf[bi, tgt], off], dim=-1)
    x = prec(F.relu(_linear(x, sd, "topo_net.pair_proj", prec))).reshape(B * S, K, -1)
    v = valid.reshape(B * S, K).bool()
    pad = ~(v | ~v.any(dim=-1, keepdim=True))
    for layer in range(arch["topo_layers"]):
        x = _encoder_layer(x, sd, f"topo_net.transformer_encoder.layers.{layer}.",
                           arch["topo_heads"], pad, prec, gen)
    return _linear(x, sd, "topo_net.output_proj", prec).reshape(B, S, K)


def forward(sd, arch, rgb, points, pairs, valid, prec=FP32, gen=None):
    """The training forward: (mask logits [B, H, W, 2], edge logits
    [B, S, K])."""
    emb = encoder(sd, rgb, arch, prec)
    feats = sample_points(emb, points, arch["PATCH_SIZE"])
    return decoder(sd, emb, prec), toponet(sd, arch, points, feats, pairs, valid, prec, gen)
