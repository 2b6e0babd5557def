"""SAM's ViT image encoder in plain PyTorch, written from the published
model (Kirillov et al. 2023, github.com/facebookresearch/segment-anything,
modeling/image_encoder.py): patch embedding, absolute position embedding,
pre-norm blocks with windowed or global attention and decomposed relative
position bias, zero padding of the windows, the neck. Its `published`
sizes: embed_dim, depth, num_heads, global_attn_indexes, window_size,
patch_size, mlp_ratio, out_chans.

Work counted from the shapes (see benchmark/counts.py for the rules):
windowed attention counts the real tokens' queries against a whole window
of keys (the zero padding's keys take part in the softmax).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.counts import BF16
from benchmark.reference.model import FP32, PIXEL_MEAN, PIXEL_STD, _linear, _ln, _ln2d


def grid(arch) -> int:
    return arch["PATCH_SIZE"] // arch["patch_size"]


def param_specs(arch: dict) -> list:
    C, depth = arch["embed_dim"], arch["depth"]
    nh, ws, p = arch["num_heads"], arch["window_size"], arch["patch_size"]
    g = grid(arch)
    hd = C // nh
    out = arch["out_chans"]
    mlp = int(C * arch["mlp_ratio"])
    specs = [("image_encoder.pos_embed", (1, g, g, C), "table"),
             ("image_encoder.patch_embed.proj.weight", (C, 3, p, p), "lecun"),
             ("image_encoder.patch_embed.proj.bias", (C,), "zero")]
    for i in range(depth):
        b = f"image_encoder.blocks.{i}."
        size = g if i in arch["global_attn_indexes"] else ws
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
    return specs


# ---------------------------------------------------------------- forward


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


def forward(sd, rgb, arch, prec=FP32):
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


# ---------------------------------------------------------------- counts


def _windows(arch) -> int:
    return math.ceil(grid(arch) / arch["window_size"]) ** 2


def attention_blocks(arch) -> dict:
    """How many blocks attend globally and how many in windows."""
    n_global = len(arch["global_attn_indexes"])
    return {"global": n_global, "window": arch["depth"] - n_global}


def attention_flops(arch, kind: str) -> float:
    """Forward operations of one block's attention products for one patch:
    q.k and p.v over every head, and the decomposed rel-pos bias (q against
    the row and column tables). kind is "window" or "global"."""
    g, C = grid(arch), arch["embed_dim"]
    T = g * g
    keys, side = (arch["window_size"] ** 2, arch["window_size"]) if kind == "window" else (T, g)
    return 4.0 * T * keys * C + 4.0 * T * side * C


def attention_bytes(arch, kind: str, backward: bool = False) -> float:
    """Bytes of one block's attention for one patch in bf16. Forward: q and
    the output over the real tokens, k and v over every key (the windows'
    padding included). Backward: q, the output's gradient and q's gradient
    over the real tokens, k, v and their gradients over every key."""
    g, C = grid(arch), arch["embed_dim"]
    T = g * g
    keys = _windows(arch) * arch["window_size"] ** 2 if kind == "window" else T
    return BF16 * C * ((3 * T + 4 * keys) if backward else (2 * T + 2 * keys))


def flops(arch) -> float:
    """Patch embedding, every block's projections, MLP and attention, and
    the neck."""
    g, C, p = grid(arch), arch["embed_dim"], arch["patch_size"]
    T, out = g * g, arch["out_chans"]
    mlp = int(C * arch["mlp_ratio"])
    blocks = arch["depth"] * 2.0 * T * C * (3 * C + C + 2 * mlp)
    attn = sum(n * attention_flops(arch, kind) for kind, n in attention_blocks(arch).items())
    neck = 2.0 * T * C * out + 2.0 * T * out * out * 9
    return 2.0 * T * C * 3 * p * p + blocks + attn + neck


def params(arch) -> int:
    g, C, p = grid(arch), arch["embed_dim"], arch["patch_size"]
    hd = C // arch["num_heads"]
    mlp = int(C * arch["mlp_ratio"])
    out = arch["out_chans"]
    n = g * g * C + C * 3 * p * p + C + C * out + out * out * 9 + 4 * out
    for i in range(arch["depth"]):
        size = g if i in arch["global_attn_indexes"] else arch["window_size"]
        n += 4 * C + 2 * (2 * size - 1) * hd + 3 * C * C + 3 * C + C * C + C
        n += 2 * C * mlp + mlp + C
    return n
