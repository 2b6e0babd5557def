"""Kernel-level A/B of the port's token-tiled and window kernels against
their plain PyTorch formulations, at the flagship geometry (B = 32 patches
of 1024 tokens, ViT-B dims; 288 windows of 14 x 14): the counterpart of the
repository's tools/experiment_fused_ln.py, on the same default_rng(0) inputs.

Variants (each `<label>_l1`, the L1 norm of one output, and `<label>_ms`):
  plain_ln_dense / cuda_ln_dense   LN + qkv dense: plain vs K1
  plain_ln_mlp / cuda_ln_mlp       LN + MLP + residual: plain vs K9
  fold_attn                        rel-pos folded into q and k, then K5
  cuda_window_attn                 K12 (bias rows built in the kernel)
  cuda_rows_g{1,2,4}               K11 over bias rows from one einsum, 1, 2
                                   or 4 windows a block
  cuda_batched_attn                K13 on head-split q, k, v
  plain_textbook_attn              decomposed rel-pos attention in plain ops
The JAX tool's Pallas tile sweeps (ln_dense tile 256 / 512 / 1024, ln_mlp
tile and chunks) have no variants here: those are TPU block sizes, and the
CUDA kernels' tiles are fixed. K13 has one, which the JAX tool lacks: on the
TPU it does not compile (tools/repro_aot_crash.py).

Timing: CUDA events around `iters` calls of a variant, the variants taken in
turns for `rounds` rounds, the least per-call time of the rounds (host clock
with --device cpu, where every variant runs its plain version). Every
variant runs 1 + rounds * iters times, so each kernel's launches are exact.

    python -m sam_road_tpu_torch.tools.experiment_fused_ln [ln_dense|ln_mlp|wattn|all] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from sam_road_tpu_torch.utils.profiling import ms_per_call

WHICH = ("ln_dense", "ln_mlp", "wattn", "all")
PAIRS = {  # each kernel variant -> the plain variant of the same function
    "cuda_ln_dense": "plain_ln_dense", "cuda_ln_mlp": "plain_ln_mlp",
    "fold_attn": "plain_textbook_attn", "cuda_window_attn": "plain_textbook_attn",
    "cuda_rows_g1": "plain_textbook_attn", "cuda_rows_g2": "plain_textbook_attn",
    "cuda_rows_g4": "plain_textbook_attn", "cuda_batched_attn": "plain_textbook_attn",
}


def main(which: str = "all", device: str = "cuda", *, tokens: int = 32 * 1024, dim: int = 768,
         windows: int = 32 * 9, win: int = 14, heads: int = 12, iters: int = 10,
         rounds: int = 4) -> dict:
    """Runs the variants of `which`; returns and prints {label_l1, label_ms}.
    The geometry arguments exist so that a test can run the tool small."""
    import torch

    from sam_road_tpu_torch.models.vit import fold_rel_pos_qk, rel_pos_table
    from sam_road_tpu_torch.ops.attention import fused_attention
    from sam_road_tpu_torch.ops import fused_block, fused_ln

    if which not in WHICH:
        raise ValueError(f"which must be one of {WHICH}, got {which!r}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to run the plain versions")
    DT = torch.bfloat16
    M, C = tokens, dim
    rng = np.random.default_rng(0)

    def arr(a, dt=DT):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)

    x = arr(rng.normal(size=(M, C)) * 0.5)
    results, runners = {}, []

    def timed(label, fn, *args):
        results[label + "_l1"] = float(fn(*args).float().abs().sum())
        runners.append((label, fn, args))
        print(f"# {label}: ran", flush=True)

    with torch.no_grad():
        # ---- LN + dense (qkv shape: C -> 3C), weights [out, in] ----
        if which in ("all", "ln_dense"):
            s, b = arr(rng.normal(size=(C,))), arr(rng.normal(size=(C,)))
            w = arr(rng.normal(size=(C, 3 * C)) * 0.02).T.contiguous()
            timed("plain_ln_dense", fused_ln.ln_dense_plain, x, s, b, w)
            timed("cuda_ln_dense", fused_ln.ln_dense, x, s, b, w)

        # ---- LN + MLP + residual ----
        if which in ("all", "ln_mlp"):
            s, b = arr(rng.normal(size=(C,))), arr(rng.normal(size=(C,)))
            w1 = arr(rng.normal(size=(C, 4 * C)) * 0.02).T.contiguous()
            b1 = arr(rng.normal(size=(4 * C,)))
            w2 = arr(rng.normal(size=(4 * C, C)) * 0.02).T.contiguous()
            b2 = arr(rng.normal(size=(C,)))
            mlp = (x, s, b, w1, b1, w2, b2)
            timed("plain_ln_mlp", fused_ln.ln_mlp_residual_plain, *mlp)
            timed("cuda_ln_mlp", fused_ln.ln_mlp_residual, *mlp)

        # ---- window attention: 32 patches x 9 windows ----
        if which in ("all", "wattn"):
            nW, N, hd = windows, win * win, C // heads
            qkv = arr(rng.normal(size=(nW, N, 3 * C)) * 0.5)
            rh = arr(rng.normal(size=(2 * win - 1, hd)) * 0.02, torch.float32)
            rw = arr(rng.normal(size=(2 * win - 1, hd)) * 0.02, torch.float32)

            def heads_split(qkv):  # -> q, k, v [nW, heads, N, hd]
                return fused_block._split_heads(qkv, heads)

            merge = fused_block._merge_heads  # [nW, heads, N, hd] -> [nW, N, C]

            def fold_attn(qkv, rh, rw):
                q, k, v = heads_split(qkv)
                q_aug, k_aug = fold_rel_pos_qk(q, k, rel_pos_table(win, rh).to(DT),
                                               rel_pos_table(win, rw).to(DT), (win, win),
                                               hd ** -0.5)
                return merge(fused_attention(q_aug.contiguous(), k_aug.contiguous(),
                                             v.contiguous()))

            timed("fold_attn", fold_attn, qkv, rh, rw)
            timed("cuda_window_attn",
                  lambda qkv, rh, rw: fused_block.window_attention_relpos(qkv, rh, rw, win, heads),
                  qkv, rh, rw)

            def rows(qkv, rh, rw, group):
                # bias rows precomputed by one einsum, spread in the kernel
                q = qkv[..., :C].reshape(nW, win, win, heads, hd)
                Rh, Rw = rel_pos_table(win, rh).to(DT), rel_pos_table(win, rw).to(DT)
                bh = torch.einsum("wijhc,iac->whija", q, Rh).reshape(nW, heads, N, win)
                bw = torch.einsum("wijhc,jac->whija", q, Rw).reshape(nW, heads, N, win)
                return fused_block.window_attention_rows(qkv, bh.contiguous(), bw.contiguous(),
                                                         win, heads, group=group)

            for g in (1, 2, 4):
                timed(f"cuda_rows_g{g}", lambda qkv, rh, rw, g=g: rows(qkv, rh, rw, g),
                      qkv, rh, rw)
            q, k, v = (t.contiguous() for t in heads_split(qkv))
            timed("cuda_batched_attn",
                  lambda q, k, v, rh, rw: fused_block.window_attention_relpos_batched(
                      q, k, v, rh, rw, win), q, k, v, rh, rw)

            def textbook(qkv, rh, rw):
                # decomposed rel-pos: bias einsums and a 6D broadcast add,
                # softmax in plain ops
                q, k, v = heads_split(qkv)
                Rh, Rw = rel_pos_table(win, rh).to(DT), rel_pos_table(win, rw).to(DT)
                s = torch.einsum("bhnd,bhmd->bhnm", q * hd ** -0.5, k).float()
                r_q = q.reshape(nW, heads, win, win, hd)
                relh = torch.einsum("bhiwc,iac->bhiwa", r_q, Rh)
                relw = torch.einsum("bhiwc,wac->bhiwa", r_q, Rw)
                s = s.reshape(nW, heads, win, win, win, win)
                s = s + relh[..., :, None].float() + relw[..., None, :].float()
                p = torch.softmax(s.reshape(nW, heads, N, N), dim=-1).to(DT)
                return merge(torch.einsum("bhnm,bhmd->bhnd", p, v))

            timed("plain_textbook_attn", textbook, qkv, rh, rw)

        times = {label: [] for label, _, _ in runners}
        for _ in range(rounds):
            for label, fn, args in runners:
                times[label].append(ms_per_call(lambda: fn(*args), iters, dev))
    for label, ts in times.items():
        results[label + "_ms"] = min(ts)
        print(f"# {label}: {results[label + '_ms']} ms", flush=True)
    print(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="all", choices=WHICH)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    a = ap.parse_args()
    main(a.which, a.device)
