"""SAMRoad: SAM ViT encoder + mask decoder + TopoNet (counterpart of
sam_road_tpu/models/sam_road.py): the training forward and the two
inference entry points the engine uses. The mask decoder is the naive
map_decoder, or with USE_SAM_DECODER SAM's own (models/sam_decoder.py:
prompt_encoder and mask_decoder, no map_decoder); ENCODER_LORA adds rank
LORA_RANK adapters to every encoder block's qkv (models/vit.py::LoRAQKV)."""

from __future__ import annotations

import torch
from torch import nn

from sam_road_tpu_torch.models.decoder import MapDecoder
from sam_road_tpu_torch.models.sam_decoder import MaskDecoder, PromptEncoder, sam_mask_logits
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
                 dtype=torch.bfloat16, remat: bool = False, use_sam_decoder: bool = False,
                 lora_rank: int = 0):
        super().__init__()
        if sam_version not in ENCODER_SPECS:
            raise ValueError(f"unknown SAM_VERSION {sam_version!r}")
        self.sam_version = sam_version
        self.patch_size = patch_size
        self.dtype = dtype
        self.use_sam_decoder = use_sam_decoder
        self.lora_rank = lora_rank
        enc = ENCODER_SPECS[sam_version]
        self.image_encoder = ImageEncoderViT(
            img_size=patch_size, embed_dim=enc["embed_dim"], depth=enc["depth"],
            num_heads=enc["num_heads"],
            global_attn_indexes=enc["global_attn_indexes"], use_flash=use_flash,
            dtype=dtype, remat=remat, lora_rank=lora_rank)
        if use_sam_decoder:
            self.prompt_encoder = PromptEncoder()
            self.mask_decoder = MaskDecoder()
        else:
            self.map_decoder = MapDecoder()
        self.topo_net = TopoNet(feature_dim=256, version=toponet_version)

    @classmethod
    def from_config(cls, config) -> "SAMRoad":
        """The JAX ModelSpec.from_config's reading: LORA_RANK counts only
        with ENCODER_LORA."""
        return cls(sam_version=str(config.SAM_VERSION),
                   patch_size=int(config.PATCH_SIZE),
                   toponet_version=str(config.TOPONET_VERSION or "normal"),
                   use_flash=bool(config.FLASH_ATTENTION),
                   dtype=DTYPES[str(config.COMPUTE_DTYPE or "float32")],
                   remat=bool(config.REMAT_ENCODER),
                   use_sam_decoder=bool(config.USE_SAM_DECODER),
                   lora_rank=int(config.LORA_RANK) if config.ENCODER_LORA else 0)

    def normalize(self, rgb):
        """uint8-range [B, H, W, 3] -> normalised input in self.dtype."""
        mean = torch.tensor(PIXEL_MEAN, dtype=torch.float32, device=rgb.device)
        std = torch.tensor(PIXEL_STD, dtype=torch.float32, device=rgb.device)
        return ((rgb.float() - mean) / std).to(self.dtype)

    def mask_logits(self, embeddings):
        """Feature maps -> fp32 mask logits [B, H, W, 2] through the map
        decoder or SAM's."""
        if self.use_sam_decoder:
            return sam_mask_logits(self.prompt_encoder, self.mask_decoder, embeddings,
                                   self.patch_size)
        return self.map_decoder(embeddings).float()

    def decode_masks(self, embeddings):
        """Feature maps -> fp32 sigmoid mask scores [B, H, W, 2]."""
        return torch.sigmoid(self.mask_logits(embeddings))

    def forward(self, rgb, graph_points, pairs, valid, deterministic=True, generator=None,
                encoder=None):
        """Training forward (sam_road_tpu/models/sam_road.py::SAMRoad.__call__).

        rgb [B, H, W, 3] uint8-range floats; graph_points [B, P, 2] (x, y)
        patch pixels; pairs [B, S, K, 2] indices into graph_points; valid
        [B, S, K] bool. Dropout in TopoNet draws from `generator` unless
        deterministic. `encoder(module, x)` replaces the eager encoder
        forward (training/harness.py::_fused_forward passes the
        differentiable fused one). Returns fp32 mask_logits, mask_scores
        [B, H, W, 2] and topo_logits, topo_scores [B, S, K, 1]."""
        x = self.normalize(rgb)
        emb = self.image_encoder(x) if encoder is None else encoder(self.image_encoder, x)
        mask_logits = self.mask_logits(emb)
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
    package's init_params; a ConvTranspose's fan-in is its input channels),
    biases 0, norms identity, pos_embed and rel-pos tables ~ N(0, 0.02^2),
    the SAM decoder's tokens, no-mask embedding and Gaussian matrix
    ~ N(0, 1). LoRA's B stays zero, as the JAX init leaves it, so the
    adapters start as the identity and an encoder overlaid from a SAM
    checkpoint starts as SAM's."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("pos_embed", "rel_pos_h", "rel_pos_w"):
            p.copy_(0.02 * torch.randn(p.shape, generator=gen))
        elif ".linear_b_" in name:
            p.zero_()
        elif name.endswith(("iou_token.weight", "mask_tokens.weight", "no_mask_embed.weight",
                            "positional_encoding_gaussian_matrix")):
            p.copy_(torch.randn(p.shape, generator=gen))
        elif p.ndim >= 2:
            conv_t = name.startswith("map_decoder") or ".output_upscaling." in name
            fan_in = p.shape[0] if conv_t else p[0].numel()
            p.copy_(torch.randn(p.shape, generator=gen) * fan_in ** -0.5)
        elif "norm" in name or name.endswith(("neck.1.weight", "neck.3.weight",
                                              "map_decoder.1.weight",
                                              "output_upscaling.1.weight")):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        else:
            p.zero_()
    return model
