"""Checkpoint verification: from a SAM .pth or SAMRoad .ckpt file to a
stage-by-stage parity report in one command (counterpart of the
repository's tools/verify_real_ckpt.py).

    python -m sam_road_tpu_torch.tools.verify_real_ckpt CKPT [--sam-version vit_b]
        [--patch-size 512] [--oracle] [--seed 0] [--device cpu]

  1. models/convert.py::load_and_convert (the pos-embed resize, then the
     name-and-shape overlay on a fresh model), reporting the matched and
     mismatched parameters by subsystem and any encoder parameter left at
     its initialisation;
  2. one patch from np.random.default_rng(seed), normalised, through the
     port's ImageEncoderViT at fp32 (every attention through K5's fp32
     kernel on the card): each block's output (forward hooks), the neck's,
     and the map decoder's mask scores when the checkpoint carries
     map_decoder; mean, std and L1 of each stage, comparable across
     machines and runs;
  3. with --oracle, the same stages of tests/torch_oracle.py's
     OracleImageEncoderViT (loaded by path; torch only, numerics of the
     reference's SAM submodule) on the checkpoint's state dict, resized as
     the converter resizes it, on the CPU in fp32: each stage's max abs
     difference over the oracle's std, and the worst (PASS below 1e-3).

TF32 is turned off for matmul and cuDNN, so the card's fp32 products and
the patch-embedding convolution keep fp32 precision. No real checkpoint is
in the repository; tests and chip_smoke.py run the tool on full-shape
fakes.
"""

from __future__ import annotations

import argparse
import importlib.util
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PASS_TOL = 1e-3


def _stats(name, arr) -> dict:
    a = np.asarray(arr, np.float64)
    return {"stage": name, "shape": tuple(a.shape), "mean": float(a.mean()),
            "std": float(a.std()), "l1": float(np.abs(a).mean())}


def _bucket(names) -> dict:
    b: dict = {}
    for n in names:
        top = n.split(".")[0]
        b[top] = b.get(top, 0) + 1
    return dict(sorted(b.items()))


def _oracle_module():
    path = os.path.join(REPO, "tests", "torch_oracle.py")
    spec = importlib.util.spec_from_file_location("torch_oracle", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def oracle_stages(ckpt_path: str, sam_version: str, patch_size: int, x) -> dict:
    """The oracle encoder's block outputs and neck (NHWC, numpy) on x
    [1, p, p, 3] normalised, on the CPU in fp32."""
    import torch

    from sam_road_tpu_torch.models.convert import load_torch_state_dict, resize_sam_pos_embed
    from sam_road_tpu_torch.models.vit import ENCODER_SPECS

    spec = ENCODER_SPECS[sam_version]
    sd = load_torch_state_dict(ckpt_path)
    if patch_size != 1024 and "image_encoder.pos_embed" in sd:
        sd = resize_sam_pos_embed(sd, patch_size, 16, spec["global_attn_indexes"])
    o = _oracle_module().OracleImageEncoderViT(
        img_size=patch_size, embed_dim=spec["embed_dim"], depth=spec["depth"],
        num_heads=spec["num_heads"], out_chans=256, window_size=14,
        global_attn_indexes=tuple(spec["global_attn_indexes"])).eval()
    o_sd = {k[len("image_encoder."):]: torch.as_tensor(np.asarray(v))
            for k, v in sd.items() if k.startswith("image_encoder.")}
    missing, _ = o.load_state_dict(o_sd, strict=False)
    acts = {"missing": missing}
    for i, blk in enumerate(o.blocks):
        blk.register_forward_hook(
            lambda mod, inp, outp, i=i: acts.__setitem__(f"block_{i}", outp.detach().numpy()))
    with torch.no_grad():
        acts["neck"] = o(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    return acts


def run(ckpt_path: str, sam_version: str = "vit_b", patch_size: int = 512,
        oracle: bool = False, seed: int = 0, out=print, device: str = "cuda") -> dict:
    """The report (module docstring) through `out`; returns {"matched",
    "mismatched" (counts), "buckets", "rows" (each stage's stats), "worst"
    (with `oracle`, else None), "launches", "device"}."""
    import torch

    from sam_road_tpu_torch.config import load_config
    from sam_road_tpu_torch.models.convert import load_and_convert
    from sam_road_tpu_torch.models.sam_road import PIXEL_MEAN, PIXEL_STD
    from sam_road_tpu_torch.ops import _build
    from sam_road_tpu_torch.tools import bench

    dev = bench.require_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(overrides=dict(SAM_VERSION=sam_version, PATCH_SIZE=patch_size,
                                     COMPUTE_DTYPE="float32"))
    model, matched, mismatched = load_and_convert(ckpt_path, cfg)
    buckets = {"matched": _bucket(matched), "mismatched": _bucket(mismatched)}
    out(f"== {ckpt_path} ==")
    out(f"matched params:    {len(matched)}  {buckets['matched']}")
    out(f"mismatched params: {len(mismatched)}  {buckets['mismatched']}")
    enc_miss = [m for m in mismatched if m.startswith("image_encoder")]
    if enc_miss:
        out("encoder params NOT loaded (kept init):")
        for m in enc_miss:
            out(f"  {m}")

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, size=(1, patch_size, patch_size, 3)).astype(np.float32)
    x = (img - np.asarray(PIXEL_MEAN, np.float32)) / np.asarray(PIXEL_STD, np.float32)

    enc = model.image_encoder.to(dev).eval()
    acts = {}
    for i, blk in enumerate(enc.blocks):
        blk.register_forward_hook(
            lambda mod, inp, outp, i=i: acts.__setitem__(f"block_{i}", outp.detach()))
    _build.reset_launches()
    with torch.no_grad():
        emb = enc(torch.from_numpy(x).to(dev))
        got = {name: a.cpu().numpy() for name, a in acts.items()}  # the blocks in order
        got["neck"] = emb.cpu().numpy()
        rows = [_stats(name, a) for name, a in got.items()]
        if "map_decoder" in buckets["matched"]:
            model.map_decoder.to(dev)
            rows.append(_stats("mask_scores", model.decode_masks(emb).cpu().numpy()))
    bench.sync(dev)
    launches = dict(_build.launches)
    out(f"\nper-stage activation stats (deterministic seed {seed} patch):")
    for r in rows:
        out("  %-12s %-22s mean %+.6f  std %.6f  l1 %.6f"
            % (r["stage"], r["shape"], r["mean"], r["std"], r["l1"]))
    result = {"matched": len(matched), "mismatched": len(mismatched), "buckets": buckets,
              "rows": rows, "worst": None, "launches": launches,
              "device": bench.device_name(dev)}
    if not oracle:
        return result

    want = oracle_stages(ckpt_path, sam_version, patch_size, x)
    if want["missing"]:
        out(f"oracle missing keys (kept init): {want['missing']}")
    out("\noracle per-stage diff (relative = max abs diff / activation std):")
    worst = 0.0
    diffs = {}
    for name, a in got.items():
        d = float(np.abs(a - want[name]).max())
        rel = d / (float(np.asarray(want[name], np.float64).std()) + 1e-12)
        worst = max(worst, rel)
        diffs[name] = rel
        out(f"  {name:<9s} abs {d:.3e}  rel {rel:.3e}")
    out(f"WORST RELATIVE STAGE DIFF: {worst:.3e} "
        f"({'PASS' if worst < PASS_TOL else 'INVESTIGATE'} at fp32 rel tol {PASS_TOL:g})")
    result.update(worst=worst, oracle_rel_diff=diffs)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt")
    ap.add_argument("--sam-version", default="vit_b", choices=["vit_b", "vit_l", "vit_h"])
    ap.add_argument("--patch-size", type=int, default=512)
    ap.add_argument("--oracle", action="store_true",
                    help="side-by-side diff against the torch oracle encoder")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    a = ap.parse_args(argv)
    return run(a.ckpt, a.sam_version, a.patch_size, a.oracle, a.seed, device=a.device)


if __name__ == "__main__":
    main()
