"""SAMRoad: SAM ViT encoder + map decoder + TopoNet (counterpart of
sam_road_tpu/models/sam_road.py): the training forward and the two
inference entry points the engine uses. The SAM mask decoder and LoRA are
not ported yet."""

from __future__ import annotations

import torch
from torch import nn

from sam_road_tpu_torch.models.decoder import MapDecoder
from sam_road_tpu_torch.models.toponet import TopoNet
from sam_road_tpu_torch.models.vit import ENCODER_SPECS, ImageEncoderViT
from sam_road_tpu_torch.ops.sampling import bilinear_sample_points

# ImageNet pixel statistics (reference: model.py:229-230)
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class SAMRoad(nn.Module):
    def __init__(self, sam_version: str = "vit_b", patch_size: int = 512,
                 toponet_version: str = "normal", use_flash: bool = True,
                 dtype=torch.bfloat16):
        super().__init__()
        if sam_version not in ENCODER_SPECS:
            raise ValueError(f"unknown SAM_VERSION {sam_version!r}")
        self.sam_version = sam_version
        self.patch_size = patch_size
        self.dtype = dtype
        enc = ENCODER_SPECS[sam_version]
        self.image_encoder = ImageEncoderViT(
            img_size=patch_size, embed_dim=enc["embed_dim"], depth=enc["depth"],
            num_heads=enc["num_heads"],
            global_attn_indexes=enc["global_attn_indexes"], use_flash=use_flash,
            dtype=dtype)
        self.map_decoder = MapDecoder()
        self.topo_net = TopoNet(feature_dim=256, version=toponet_version)

    @classmethod
    def from_config(cls, config) -> "SAMRoad":
        if config.USE_SAM_DECODER or config.ENCODER_LORA:
            raise NotImplementedError("USE_SAM_DECODER and ENCODER_LORA are not ported yet")
        return cls(sam_version=str(config.SAM_VERSION),
                   patch_size=int(config.PATCH_SIZE),
                   toponet_version=str(config.TOPONET_VERSION or "normal"),
                   use_flash=bool(config.FLASH_ATTENTION),
                   dtype=DTYPES[str(config.COMPUTE_DTYPE or "float32")])

    def normalize(self, rgb):
        """uint8-range [B, H, W, 3] -> normalised input in self.dtype."""
        mean = torch.tensor(PIXEL_MEAN, dtype=torch.float32, device=rgb.device)
        std = torch.tensor(PIXEL_STD, dtype=torch.float32, device=rgb.device)
        return ((rgb.float() - mean) / std).to(self.dtype)

    def decode_masks(self, embeddings):
        """Feature maps -> fp32 sigmoid mask scores [B, H, W, 2]."""
        return torch.sigmoid(self.map_decoder(embeddings).float())

    def forward(self, rgb, graph_points, pairs, valid, deterministic=True, generator=None):
        """Training forward (sam_road_tpu/models/sam_road.py::SAMRoad.__call__).

        rgb [B, H, W, 3] uint8-range floats; graph_points [B, P, 2] (x, y)
        patch pixels; pairs [B, S, K, 2] indices into graph_points; valid
        [B, S, K] bool. Dropout in TopoNet draws from `generator` unless
        deterministic. Returns fp32 mask_logits, mask_scores [B, H, W, 2] and
        topo_logits, topo_scores [B, S, K, 1]."""
        emb = self.image_encoder(self.normalize(rgb))
        mask_logits = self.map_decoder(emb).float()
        feats = bilinear_sample_points(emb, graph_points, self.patch_size)
        topo_logits, topo_scores = self.topo_net(graph_points, feats, pairs, valid,
                                                 deterministic, generator)
        return mask_logits, torch.sigmoid(mask_logits), topo_logits.float(), topo_scores

    def infer_masks_and_features(self, rgb, encoder=None):
        """Phase 1: (mask scores [B, H, W, 2] fp32, embeddings [B, h, w, 256]).
        `encoder(module, x)` replaces the eager encoder forward (the engine
        passes models.fast_encoder.encoder_forward_fused)."""
        x = self.normalize(rgb)
        emb = self.image_encoder(x) if encoder is None else encoder(self.image_encoder, x)
        return self.decode_masks(emb), emb

    def infer_toponet(self, embeddings, graph_points, pairs, valid):
        """Phase 2: fp32 edge scores [B, S, K, 1] from cached embeddings."""
        feats = bilinear_sample_points(embeddings, graph_points, self.patch_size)
        _, scores = self.topo_net(graph_points, feats, pairs, valid)
        return scores


@torch.no_grad()
def init_random(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights (there are no checkpoints to load yet): every
    matrix and conv kernel ~ N(0, 1/fan_in) (flax's lecun_normal, as the JAX
    package's init_params), biases 0, norms identity, pos_embed and rel-pos
    tables ~ N(0, 0.02^2)."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("pos_embed", "rel_pos_h", "rel_pos_w"):
            p.copy_(0.02 * torch.randn(p.shape, generator=gen))
        elif p.ndim >= 2:
            fan_in = p.shape[0] if name.startswith("map_decoder") else p[0].numel()
            p.copy_(torch.randn(p.shape, generator=gen) * fan_in ** -0.5)
        elif "norm" in name or name.endswith(("neck.1.weight", "neck.3.weight",
                                              "map_decoder.1.weight")):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        else:
            p.zero_()
    return model
