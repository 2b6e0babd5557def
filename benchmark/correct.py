"""The numbers that decide `correct`, each from what the timed path
produced and the plain reference (benchmark/reference/), and the verdict
against the cell's limits (benchmark/limits/<cell>.json: for each number
its limit, and the readings it was set from).

Region cells, per distinct output of the window:
  mask_gap          largest |program - reference| of a fused uint8 mask
                    pixel, keypoint and road, in levels of 1/255, over the
                    window's outputs and the set-up's calibration masks;
  threshold_mismatch  thresholds that differ between the program's set-up
                    and the reference's calibration rule applied to the
                    program's calibration masks (exact: mask_gap checks
                    those masks, this the rule);
  vertex_mismatch   vertices that differ between the program's and the
                    reference's extraction from the program's masks at the
                    reference's thresholds, plus the difference of their
                    counts (the reference follows the program's masks here,
                    so this is exact);
  score_mean_gap    the mean over every pair of |program - reference| of
                    its score averaged over the patches that scored it: the
                    program's are the int16 scores its phase 2 handed to
                    the host aggregation in the window, the reference's
                    TopoNet on its own features at the program's vertices
                    and pairs; a pair that only one side scored reads 1;
  score_patch_gap   by the worst patch, the mean over its pairs of
                    |program - reference| of that patch's own score (a
                    patch whose pairs the reference did not score reads 1),
                    so that a fault in one of a region's patches shows
                    undiluted (a pair is scored by up to ~30 patches);
  edge_mismatch     edges of the output that differ from the pairs whose
                    program score averages above TOPO_THRESHOLD (exact).
Training cells, over the first three steps:
  loss_gap          largest |program - reference| / |reference| of a
                    step's loss;
  grad_norm_gap     the same for the first step's total gradient norm;
  grad_leaf_gap     by the worst leaf, |norm of the program's first
                    gradient (Adam's first moment after step 1 over
                    1 - beta1) - the reference's| over the larger of the
                    reference's norm and the median leaf's;
  change_gap        the same for the parameters' change over the three
                    steps, over the elements whose reference gradient is
                    at least a thousandth of the median leaf's RMS (the
                    others, such as the key's third of each qkv bias,
                    whose gradient is nought under softmax, move under
                    Adam by round-off alone);
  skipped           steps the program skipped as not finite.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from benchmark.reference import model, region as ref_region, train as ref_train

HERE = os.path.dirname(os.path.abspath(__file__))


def limits_of(cell: str) -> dict:
    with open(os.path.join(HERE, "limits", f"{cell}.json")) as f:
        return json.load(f)


def verdict(numbers: dict, limits: dict):
    """(correct, [[name, number, limit]]): every number at or under its
    limit; a number that is not finite fails."""
    rows = [[k, numbers[k], limits[k]["limit"]] for k in limits]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return bool(ok), rows


# ---------------------------------------------------------------- regions


def pair_scores(scored, n_points: int) -> dict:
    """{(source, target): mean score} from phase 2's int16 scores
    (round(s * 32767), -32768 for NaN, which counts as -100), summed as
    integers and divided once, as the program's aggregation does."""
    if not scored:
        return {}
    src, tgt, q = (np.concatenate(a) for a in zip(*scored))
    keys = src.astype(np.int64) * n_points + tgt
    uniq, inv = np.unique(keys, return_inverse=True)
    nan = q == -(2 ** 15)
    sum_q = np.zeros(len(uniq), np.int64)
    np.add.at(sum_q, inv, q.astype(np.int64))
    nans = np.bincount(inv, nan, len(uniq)).astype(np.int64)
    sums = (sum_q + 32768 * nans).astype(np.float64) / 32767.0 - 100.0 * nans
    avg = sums / np.bincount(inv, minlength=len(uniq)).astype(np.float64)
    return {(int(u // n_points), int(u % n_points)): float(a) for u, a in zip(uniq, avg)}


def patch_gap(scored, ref_patches, n_points: int) -> float:
    """The worst patch's mean |program - reference| over its own pairs.
    A program patch is matched to the reference's patches that scored the
    same pairs (the nearest of them where several did); one that matches
    none, or a count of patches that differs, reads 1."""
    def keyed(src, tgt):
        keys = np.asarray(src, np.int64) * n_points + np.asarray(tgt, np.int64)
        order = np.argsort(keys, kind="stable")
        return keys[order].tobytes(), order

    by_keys: dict = {}
    for rs, rt, rv in ref_patches:
        k, order = keyed(rs, rt)
        by_keys.setdefault(k, []).append(np.asarray(rv, np.float64)[order])
    worst = 0.0 if len(scored) == len(ref_patches) else 1.0
    for src, tgt, q in scored:
        k, order = keyed(src, tgt)
        if k not in by_keys:
            return 1.0
        q = np.asarray(q, np.int64)[order]
        prog = np.where(q == -(2 ** 15), -100.0, q / 32767.0)
        worst = max(worst, min(float(np.abs(prog - rv).mean()) for rv in by_keys[k]))
    return worst


def region_numbers(sd, arch, cfg: dict, mix: dict, regions, outputs, calibration, thresholds,
                   device, ref_cache=None) -> dict:
    """The region cell's numbers over `outputs` [(region index, (nodes
    (r, c), edges, keypoint mask, road mask), phase 2's scores as (source,
    target, int16 score) arrays a patch, or None)]: the distinct outputs of
    the window, each compared with its region's reference. `calibration`
    holds the keypoint and road masks of regions[0] from which set-up drew
    `thresholds`."""
    model.tf32_off()
    ref_cache = {} if ref_cache is None else ref_cache

    def reference(r):
        if r not in ref_cache:
            ref_cache[r] = ref_region.masks_and_features(sd, arch, regions[r], cfg, device)
        return ref_cache[r]

    def gap(kp, road, masks):
        prog = np.stack([kp, road], axis=-1).astype(np.int64)
        return float(np.abs(prog - masks.astype(np.int64)).max())

    ref_thr = ref_region.thresholds(np.stack(calibration, axis=-1), mix["itsc_quantile"],
                                    mix["road_quantile"])
    numbers = dict(mask_gap=gap(*calibration, reference(0)[0]),
                   threshold_mismatch=float(sum(ref_thr[k] != thresholds[k] for k in ref_thr)),
                   vertex_mismatch=0.0, score_mean_gap=0.0, score_patch_gap=0.0,
                   edge_mismatch=0.0)
    cfg = {**cfg, **ref_thr}
    threshold = float(cfg["TOPO_THRESHOLD"])
    for r, (nodes, edges, kp, road), scored in outputs:
        masks, feats, origins = reference(r)
        numbers["mask_gap"] = max(numbers["mask_gap"], gap(kp, road, masks))
        verts = ref_region.extract_vertices(np.stack([kp, road], axis=-1), cfg)
        prog_xy = np.asarray(nodes, np.float64).reshape(-1, 2)[:, ::-1]
        n = min(len(verts), len(prog_xy))
        numbers["vertex_mismatch"] = max(
            numbers["vertex_mismatch"],
            float(np.any(verts[:n] != prog_xy[:n], axis=1).sum() + abs(len(verts) - len(prog_xy))))
        if scored is None and len(prog_xy):  # scores that the check could not read
            for k in ("score_mean_gap", "score_patch_gap", "edge_mismatch"):
                numbers[k] = float("inf")
            continue
        scored = scored or []
        ref_patches = []
        ref_scores = ref_region.edge_scores(sd, arch, feats, origins, prog_xy, cfg, device,
                                            patches=ref_patches)
        prog_scores = pair_scores(scored, len(prog_xy))
        gaps = [abs(prog_scores[k] - ref_scores[k]) if k in prog_scores and k in ref_scores
                else 1.0 for k in prog_scores.keys() | ref_scores.keys()] or [0.0]
        numbers["score_mean_gap"] = max(numbers["score_mean_gap"], float(np.mean(gaps)))
        numbers["score_patch_gap"] = max(numbers["score_patch_gap"],
                                         patch_gap(scored, ref_patches, len(prog_xy)))
        kept = {k for k, v in prog_scores.items() if v > threshold}
        got = {(int(a), int(b)) for a, b in np.asarray(edges).reshape(-1, 2)}
        numbers["edge_mismatch"] = max(numbers["edge_mismatch"], float(len(kept ^ got)))
    return numbers


# ---------------------------------------------------------------- training


def leaf_gap(prog: dict, ref: dict) -> float:
    """Worst leaf's |norm(prog) - norm(ref)| over max(norm(ref), median
    leaf norm)."""
    rn = {k: float(torch.linalg.vector_norm(v.float())) for k, v in ref.items()}
    pn = {k: float(torch.linalg.vector_norm(prog[k].float())) for k in ref}
    med = float(np.median(list(rn.values())))
    return max(abs(pn[k] - rn[k]) / max(rn[k], med) for k in ref)


def train_numbers(sd, arch, cfg: dict, batches, program: dict, device) -> dict:
    """The training cell's numbers: `program` holds the program's first
    three steps (losses, grad_norm, skipped, first_grad and params after the
    third step, by leaf, on the host); the reference runs the same steps
    from the same state dict sd, which it does not change."""
    model.tf32_off()
    n = len(program["losses"])
    losses, g1, g1_norm, p3 = ref_train.steps(sd, arch, cfg, batches[:n], device)
    g1 = {k: v.cpu() for k, v in g1.items()}
    rms = [float(torch.linalg.vector_norm(v)) / v.numel() ** 0.5 for v in g1.values()]
    floor = 1e-3 * float(np.median(rms))
    moving = {k: v.abs() >= floor for k, v in g1.items()}
    ref_change = {k: (p3[k].cpu() - sd[k].cpu())[moving[k]] for k in sd if moving[k].any()}
    prog_change = {k: (program["params"][k] - sd[k].cpu())[moving[k]] for k in ref_change}
    return dict(
        loss_gap=max(abs(a - b[0]) / abs(b[0]) for a, b in zip(program["losses"], losses)),
        grad_norm_gap=abs(program["grad_norm"] - g1_norm) / g1_norm,
        grad_leaf_gap=leaf_gap(program["first_grad"], g1),
        change_gap=leaf_gap(prog_change, ref_change),
        skipped=float(program["skipped"]),
    )
