"""Configuration for the PyTorch port.

The same attribute dict, falsy-missing-key semantics and DEFAULTS as the
JAX package's config (sam_road_tpu/config.py), so one YAML file or override
dict configures either package; a test holds the two DEFAULTS equal key for
key. PyYAML is imported only when a file is read: overrides alone (as
chip_smoke.py uses) need nothing beyond the standard library.

Keys that exist only for the TPU engine (streaming, upload bands, meshes,
phase-2 packing/device aggregation/fetch waves/speculation, kernel A/B
switches) are carried so configs stay shared, and the port ignores them
(see inference/engine.py).
"""

from __future__ import annotations

import copy
from typing import Any, Mapping


class _Missing:
    """Falsy sentinel returned for absent config keys (addict semantics)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __bool__(self):
        return False

    def __eq__(self, other):
        return isinstance(other, _Missing)

    def __ne__(self, other):
        return not isinstance(other, _Missing)

    def __hash__(self):
        return hash(_Missing)

    def __repr__(self):
        return "<missing>"


MISSING = _Missing()


class Config(dict):
    """Dict with attribute access; missing keys return a falsy sentinel."""

    def __getattr__(self, name: str) -> Any:
        if name.startswith("__"):
            raise AttributeError(name)
        if name in self:
            return self[name]
        return MISSING

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        if name in self:
            del self[name]

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Config":
        out = cls()
        for k, v in d.items():
            out[k] = cls.from_dict(v) if isinstance(v, Mapping) else v
        return out

    def to_dict(self) -> dict:
        return {
            k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self.items()
        }


# Defaults for every key in the reference config grid (reference:
# config/toponet_vitb_512_cityscale.yaml and its ablation variants), plus
# TPU execution keys. A loaded YAML overrides these.
DEFAULTS: dict = {
    # Dataset / model family
    "DATASET": "cityscale",
    "NO_SAM": False,
    "SAM_VERSION": "vit_b",
    "SAM_CKPT_PATH": "sam_ckpts/sam_vit_b_01ec64.pth",
    # NO_SAM ablation encoder init: IN1k-MAE ViT-B trunk (reference
    # experiment: vitdet.py:78-105). Empty = random init.
    "MAE_CKPT_PATH": "",
    "PATCH_SIZE": 512,
    # Training
    "BATCH_SIZE": 16,
    "DATA_WORKER_NUM": 0,
    "VAL_VIZ_COUNT": 4,  # pred-vs-GT panels saved per val epoch
    "GRAD_CLIP_NORM": 0,  # 0 = off (reference has no clipping)
    # Inference fast path: fused Pallas encoder blocks (naive decoder,
    # no LoRA); kernel version 2 = split attention/MLP grouped-window kernels
    "FLASH_ATTENTION": True,  # False: plain XLA attention everywhere
    "INFER_UPLOAD_BANDS": 1,  # >1: sliced region uploads overlap band i+1 transfer with band i compute
    # Streamed single-chip phase 1: two column-band dispatches with DISJOINT
    # slab uploads (slab B streams over the link while band A computes) and
    # early fetch of band A's finalized mask columns during band B's compute.
    # Bit-identical masks (int32 fixed-point accumulation); falls back to the
    # whole-region single dispatch when no batch-aligned column split exists.
    "INFER_STREAM_PHASE1": True,
    # streamed phase-1 column bands: more bands shrink the serialized first
    # slab upload + last mask-chunk fetch (bit-identical at any count);
    # paired TPU A/B: 4 beat 2 every round, median +0.12 s/region
    "INFER_STREAM_BANDS": 4,
    # taper the stream plan: first/last bands ~half the interior width, so
    # the two SERIALIZED pipeline ends (first slab upload before any
    # compute, last mask-chunk fetch after all compute) shrink while the
    # interior bands keep the device saturated. Paired TPU A/B (6
    # interleaved rounds, 2026-08-18): taper won EVERY round, paired
    # delta median +0.282 s/region, phase1 min 1.956 vs 2.169 s
    "INFER_STREAM_TAPER": True,
    # serialize the streamed phase-1 slab uploads (one H2D in flight at a
    # time, slab i+1 host-blocked under band i's compute). Concurrent
    # device_puts share the link round-robin on this runtime, so band 0
    # otherwise waits ~the whole-region upload before computing
    # (tools/probe_stream_sched.py, 2026-08-19).
    "INFER_STREAM_SERIAL_UPLOAD": True,
    # phase-2 grouped score fetch in k dispatch-ordered waves: wave 1's
    # transfer rides under the later batches' TopoNet time
    "INFER_P2_FETCH_WAVES": 1,
    # SPECULATIVE phase 2 (streamed single-chip phase 1 only): while the
    # last stream band still computes, extract vertices PROVISIONALLY from
    # the already-final mask columns and dispatch TopoNet for batches whose
    # patches lie safely inside them — the scoring queue then drains under
    # the last band / mask fetch instead of after extraction. _finish
    # verifies each speculative batch's pair args against the final extraction
    # byte-for-byte and silently re-dispatches on mismatch, so results are
    # BIT-identical to the non-speculative path by construction.
    "INFER_P2_SPECULATIVE": False,
    # eligibility margin (px) from the provisional-extraction frontier;
    # 0 -> auto (2 * ROAD_NMS_RADIUS). Larger = fewer, safer speculations.
    "INFER_P2_SPEC_GUARD": 0,
    # pack all batches' phase-2 pair args into ONE upload per arg kind
    # (3 transfers instead of 3 per batch), sliced per batch on device;
    # scores exactly unchanged. Paired TPU A/B: LOST every round
    # (median -0.102 s/region) — the per-batch arg transfers are tiny
    # and pipelined, while packing delays every dispatch until all
    # batches are built. Default off; kept for slower links.
    "INFER_P2_PACK_ARGS": False,
    # aggregate phase-2 edge scores ON DEVICE: each batch's program
    # scatter-adds its int16 fixed-point scores into a per-unique-edge
    # int32 accumulator (sum/count/nan-count) that stays HBM-resident;
    # ONE small [E, 3] fetch replaces the grouped per-pair score
    # transfer, which tools/profile_extract_p2.py measured as
    # LATENCY-bound (1.4 MB in 0.13-0.19 s). Integer accumulation keeps
    # per-edge sums exact. Single-chip engines only (the dp-sharded
    # path keeps per-shard fetches). Reference host loop:
    # inferencer.py:209-221.
    "INFER_P2_DEVICE_AGG": False,
    "FUSED_ENCODER": False,
    # Route the TRAINING step's encoder through the differentiable fused
    # kernels (custom_vjp: Pallas forward, XLA-recompute backward —
    # models/fast_encoder.encoder_forward_fused(differentiable=True)).
    # Grad parity vs flax autodiff tested in tests/test_fused_train.py.
    # Measured NEGATIVE for speed (paired A/B 2026-08-19: 0.400 vs flax
    # 0.366 s/step no-remat, 0.444 vs 0.435 remat) — the recompute
    # backward re-runs the forward in XLA, costing more than the Pallas
    # forward saves. Stays off; see docs/DESIGN.md "Fused training step".
    "FUSED_ENCODER_TRAIN": False,
    # v2 kernel window grouping. ga/gm >= 4 give the kernels MXU-friendly M
    # but crash this platform's AOT compile helper at flagship window counts
    # (288 windows; HTTP 500 from tpu_compile_helper, 2026-08-16) — default
    # to the grouping that compiles everywhere. See docs/DESIGN.md.
    "TRAIN_EPOCHS": 10,
    "BASE_LR": 1e-3,
    "FREEZE_ENCODER": False,
    "ENCODER_LR_FACTOR": 0.1,
    "ENCODER_LORA": False,
    "LORA_RANK": 4,
    "FOCAL_LOSS": False,
    "USE_SAM_DECODER": False,
    # TopoNet
    "TOPO_SAMPLE_NUM": 512,
    "TOPONET_VERSION": "normal",
    # Inference
    "INFER_BATCH_SIZE": 64,
    "SAMPLE_MARGIN": 64,
    "INFER_PATCHES_PER_EDGE": 16,
    "ITSC_THRESHOLD": 0.248,
    "ROAD_THRESHOLD": 0.364,
    "TOPO_THRESHOLD": 0.500,
    "ITSC_NMS_RADIUS": 8,
    "ROAD_NMS_RADIUS": 16,
    "NEIGHBOR_RADIUS": 64,
    "MAX_NEIGHBOR_QUERIES": 16,
    # --- TPU execution knobs (new in this framework) ---
    # Compute dtype for matmuls/activations; params and reductions stay fp32.
    "COMPUTE_DTYPE": "bfloat16",
    # Device mesh: number of data-parallel shards. 0/absent => all devices.
    "DP_SHARDS": 0,
    # Sequence parallelism for region inference: shard each patch's encoder
    # TOKEN GRID row-wise over a mesh of this size (parallel/seq_parallel.py)
    # — the scale-out for big patches (1024px+, vit_l/h), where DP_SHARDS
    # scales big regions. Requires (PATCH_SIZE/16) % SP_SHARDS == 0;
    # mutually exclusive with DP_SHARDS. 0/1 => off.
    "SP_SHARDS": 0,
    # Gradient checkpointing of encoder blocks (trades FLOPs for HBM).
    "REMAT_ENCODER": False,
    # Profiling trace dir; empty disables.
    "TRACE_DIR": "",
}


def load_config(path: str | None = None, overrides: Mapping[str, Any] | None = None) -> Config:
    """Load a YAML config on top of DEFAULTS, then apply overrides."""
    cfg = Config.from_dict(DEFAULTS)
    if path is not None:
        import yaml

        with open(path) as f:
            loaded = yaml.safe_load(f) or {}
        for k, v in loaded.items():
            cfg[k] = Config.from_dict(v) if isinstance(v, Mapping) else v
    if overrides:
        for k, v in overrides.items():
            cfg[k] = v
    return cfg
