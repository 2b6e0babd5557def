"""SAM-Road's forward in plain PyTorch, written from the published models.

The SAM ViT image encoder (Kirillov et al. 2023, github.com/facebookresearch/
segment-anything, modeling/image_encoder.py: patch embedding, absolute
position embedding, pre-norm blocks with windowed or global attention and
decomposed relative position bias, zero padding of the windows, the neck),
SAM-Road's naive map decoder and TopoNet (github.com/htcr/sam_road,
model.py: four stride-2 transposed convolutions; a point-feature projection,
pair features [src, tgt, tgt - src], a 3-layer post-norm
nn.TransformerEncoder with ReLU and dropout 0.1 inside each source point's
group of pairs, one logit per pair), and F.grid_sample's bilinear point
sampling.

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
    order. init: "lecun" N(0, 1 / fan_in), "table" N(0, 0.02^2), "one", "zero".
    `arch` is a configuration file's `published` block plus its PATCH_SIZE."""
    C, depth = arch["embed_dim"], arch["depth"]
    nh, ws, p = arch["num_heads"], arch["window_size"], arch["patch_size"]
    grid = arch["PATCH_SIZE"] // p
    hd = C // nh
    out = arch["out_chans"]
    mlp = int(C * arch["mlp_ratio"])
    specs = [("image_encoder.pos_embed", (1, grid, grid, C), "table"),
             ("image_encoder.patch_embed.proj.weight", (C, 3, p, p), "lecun"),
             ("image_encoder.patch_embed.proj.bias", (C,), "zero")]
    for i in range(depth):
        b = f"image_encoder.blocks.{i}."
        size = grid if i in arch["global_attn_indexes"] else ws
        specs += [(b + "norm1.weight", (C,), "one"), (b + "norm1.bias", (C,), "zero"),
                  (b + "attn.rel_pos_h", (2 * size - 1, hd), "table"),
                  (b + "attn.rel_pos_w", (2 * size - 1, hd), "table"),
                  (b + "attn.qkv.weight", (3 * C, C), "lecun"),
                  (b + "attn.qkv.bias", (3 * C,), "zero"),
                  (b + "attn.proj.weight", (C, C), "lecun"), (b + "attn.proj.bias", (C,), "zero"),
                  (b + "norm2.weight", (C,), "one"), (b + "norm2.bias", (C,), "zero"),
                  (b + "mlp.lin1.weight", (mlp, C), "lecun"), (b + "mlp.lin1.bias", (mlp,), "zero"),
                  (b + "mlp.lin2.weight", (C, mlp), "lecun"), (b + "mlp.lin2.bias", (C,), "zero")]
    specs += [("image_encoder.neck.0.weight", (out, C, 1, 1), "lecun"),
              ("image_encoder.neck.1.weight", (out,), "one"),
              ("image_encoder.neck.1.bias", (out,), "zero"),
              ("image_encoder.neck.2.weight", (out, out, 3, 3), "lecun"),
              ("image_encoder.neck.3.weight", (out,), "one"),
              ("image_encoder.neck.3.bias", (out,), "zero")]
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


# ---------------------------------------------------------------- encoder


def _linear(x, sd, name, prec):
    return prec(F.linear(prec(x), prec(sd[name + ".weight"]), sd[name + ".bias"]))


def _ln(x, sd, name, eps, prec):
    return prec(F.layer_norm(x, x.shape[-1:], sd[name + ".weight"], sd[name + ".bias"], eps))


def _rel_pos(q_size: int, k_size: int, table):
    """SAM's get_rel_pos where no interpolation is needed."""
    coords = (torch.arange(q_size)[:, None] - torch.arange(k_size)[None, :]) + (k_size - 1)
    return table[coords.to(table.device)]


def _attention(x, sd, b, nh, prec):
    """SAM's Attention with use_rel_pos over x [B, H, W, C]."""
    B, H, W, C = x.shape
    hd = C // nh
    qkv = _linear(x.reshape(B, H * W, C), sd, b + "attn.qkv", prec)
    qkv = qkv.reshape(B, H * W, 3, nh, hd).permute(2, 0, 3, 1, 4).reshape(3, B * nh, H * W, hd)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = prec(q * hd ** -0.5) @ prec(k).transpose(-2, -1)
    Rh = _rel_pos(H, H, sd[b + "attn.rel_pos_h"])
    Rw = _rel_pos(W, W, sd[b + "attn.rel_pos_w"])
    r_q = prec(q).reshape(B * nh, H, W, hd)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, prec(Rh))
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, prec(Rw))
    attn = (attn.view(B * nh, H, W, H, W) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :]).view(B * nh, H * W, H * W)
    attn = attn.softmax(dim=-1)
    out = prec(prec(attn) @ prec(v)).view(B, nh, H, W, hd).permute(0, 2, 3, 1, 4)
    out = out.reshape(B, H, W, C)
    return _linear(out, sd, b + "attn.proj", prec)


def _block(x, sd, b, nh, ws, prec):
    shortcut = x
    x = _ln(x, sd, b + "norm1", 1e-6, prec)
    if ws > 0:
        B, H, W, C = x.shape
        ph, pw = (ws - H % ws) % ws, (ws - W % ws) % ws
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
        Hp, Wp = H + ph, W + pw
        x = x.view(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
        x = _attention(x.reshape(-1, ws, ws, C), sd, b, nh, prec)
        x = x.view(B, Hp // ws, Wp // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, Hp, Wp, C)[:, :H, :W]
    else:
        x = _attention(x, sd, b, nh, prec)
    x = prec(shortcut + x)
    h = _ln(x, sd, b + "norm2", 1e-6, prec)
    h = _linear(prec(F.gelu(_linear(h, sd, b + "mlp.lin1", prec))), sd, b + "mlp.lin2", prec)
    return prec(x + h)


def _ln2d(x, sd, name, prec):
    """SAM's LayerNorm2d (eps 1e-6) over NCHW channels."""
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + 1e-6)
    return prec(sd[name + ".weight"][:, None, None] * x + sd[name + ".bias"][:, None, None])


def encoder(sd, rgb, arch, prec=FP32):
    """rgb [B, H, W, 3] in 0-255 -> embeddings [B, 256, H / 16, W / 16]."""
    mean = torch.tensor(PIXEL_MEAN, device=rgb.device)
    std = torch.tensor(PIXEL_STD, device=rgb.device)
    x = prec((rgb.float() - mean) / std).permute(0, 3, 1, 2)
    e = "image_encoder."
    x = prec(F.conv2d(x, prec(sd[e + "patch_embed.proj.weight"]),
                      sd[e + "patch_embed.proj.bias"], stride=arch["patch_size"]))
    x = prec(x.permute(0, 2, 3, 1) + sd[e + "pos_embed"])
    for i in range(arch["depth"]):
        ws = 0 if i in arch["global_attn_indexes"] else arch["window_size"]
        x = _block(x, sd, f"{e}blocks.{i}.", arch["num_heads"], ws, prec)
    x = x.permute(0, 3, 1, 2)
    x = _ln2d(F.conv2d(x, prec(sd[e + "neck.0.weight"])), sd, e + "neck.1", prec)
    return _ln2d(F.conv2d(x, prec(sd[e + "neck.2.weight"]), padding=1), sd, e + "neck.3", prec)


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
