"""The framework from end to end on a synthetic dataset (counterpart of the
repository's examples/end_to_end_synthetic.py).

Builds a small SpaceNet-format fixture (street-grid ground-truth graphs
drawn into the imagery: tools/_fixtures.py::make_spacenet_fixture, 160 px
tiles, 2 train / 1 validation / 1 test), trains SAMRoad-tiny from random
weights through cli.train (vit_t, 80 px patches, batch 16, bf16, 4 epochs
of 150 steps), calibrates the keypoint and road thresholds through
cli.test, rewrites the config with them, runs region inference on the test
tiles through cli.infer and scores the graphs with cli.evaluate (APLS,
TOPO). It prints one `E2E_ARTIFACT` line: the scores and the inference
time of the same cli.infer invocation whose graphs were scored, with the
JAX example's keys; E2E_JSON_OUT, when set, names a file that receives it
too. Everything runs on the card unless the caller names the CPU.

    python -m sam_road_tpu_torch.examples.end_to_end_synthetic [workdir]

main() also returns what the stages took (`seconds`), the mean training
loss of each epoch, the training steps' median seconds and the median of
their waits for the loader (the first step left out of both), and the
kernels' launches by stage.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time

CONFIG = (
    "DATASET: 'spacenet'\nIMAGE_SIZE: 160\nSAM_VERSION: 'vit_t'\n"
    "PATCH_SIZE: 80\nBATCH_SIZE: 16\nTRAIN_EPOCHS: {epochs}\nBASE_LR: 0.001\n"
    "TOPO_SAMPLE_NUM: 16\nMAX_NEIGHBOR_QUERIES: 8\nNEIGHBOR_RADIUS: 48\n"
    "ROAD_NMS_RADIUS: 8\nITSC_NMS_RADIUS: 4\nITSC_THRESHOLD: 0.37\n"
    "ROAD_THRESHOLD: 0.57\nTOPO_THRESHOLD: 0.5\nINFER_BATCH_SIZE: 4\n"
    "INFER_PATCHES_PER_EDGE: 4\nSAMPLE_MARGIN: 0\n"
    "COMPUTE_DTYPE: 'bfloat16'\n"
)
# the JAX example's artifact keys
ARTIFACT_KEYS = ("what", "apls", "topo", "inference_time_txt", "config")


def main(workdir: str | None = None, epochs: int = 4, steps_per_epoch: int = 150,
         device: str = "cuda") -> dict:
    """The workflow above; returns {artifact, seconds, epoch_loss,
    step_seconds, wait_seconds, launches}. The defaults are the JAX
    example's settings."""
    from sam_road_tpu_torch.cli.evaluate import main as eval_main
    from sam_road_tpu_torch.cli.infer import main as infer_main
    from sam_road_tpu_torch.cli.test import main as test_main
    from sam_road_tpu_torch.cli.train import main as train_main
    from sam_road_tpu_torch.ops import _build
    from sam_road_tpu_torch.tools._fixtures import make_spacenet_fixture

    workdir = workdir or tempfile.mkdtemp(prefix="samroad_e2e_")
    workdir = os.path.abspath(workdir)
    print(f"workdir: {workdir}", flush=True)
    seconds, launches = {}, {}

    def stage(name, fn):
        before = dict(_build.launches)
        t = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t
        launches[name] = {k: v - before.get(k, 0) for k, v in _build.launches.items()
                          if v != before.get(k, 0)}
        return out

    stage("fixture", lambda: make_spacenet_fixture(workdir, image_size=160, spacing=40))
    cfg_path = os.path.join(workdir, "cfg.yaml")
    with open(cfg_path, "w") as f:
        f.write(CONFIG.format(epochs=epochs))

    run_dir = os.path.join(workdir, "run")
    trainer = stage("train", lambda: train_main(
        ["--config", cfg_path, "--data_root", workdir, "--output_dir", run_dir,
         "--steps_per_epoch", str(steps_per_epoch), "--device", device]))
    ckpt = os.path.join(run_dir, f"ckpt_epoch_{epochs - 1}.pt")

    thr_json = os.path.join(workdir, "thresholds.json")
    thr = stage("test", lambda: test_main(
        ["--config", cfg_path, "--checkpoint", ckpt, "--data_root", workdir,
         "--output_json", thr_json, "--device", device]))

    # the config again, with the calibrated thresholds
    cfg2 = os.path.join(workdir, "cfg_infer.yaml")
    with open(cfg_path) as f:
        text = f.read()
    text = text.replace("ITSC_THRESHOLD: 0.37",
                        f"ITSC_THRESHOLD: {thr['keypoint']['threshold']:.4f}")
    text = text.replace("ROAD_THRESHOLD: 0.57",
                        f"ROAD_THRESHOLD: {thr['road']['threshold']:.4f}")
    with open(cfg2, "w") as f:
        f.write(text)

    cwd = os.getcwd()
    os.chdir(workdir)  # cli.infer writes ./save/<output_dir>
    try:
        stage("infer", lambda: infer_main(
            ["--config", cfg2, "--checkpoint", ckpt, "--data_root", workdir,
             "--output_dir", "learned", "--device", device]))
        stage("evaluate", lambda: eval_main(
            ["--run_dir", "save/learned", "--dataset", "spacenet", "--data_root", workdir]))
        with open("save/learned/score/apls.json") as f:
            apls = json.load(f)
        with open("save/learned/score/topo.json") as f:
            topo = json.load(f)
        with open("save/learned/inference_time.txt") as f:
            time_txt = f.read()
    finally:
        os.chdir(cwd)
    print("scores:", json.dumps(apls), json.dumps(topo), flush=True)

    # quality (the trained checkpoint's APLS / TOPO) and speed (the seconds
    # of the same cli.infer invocation that produced the scored graphs) in
    # one record
    artifact = {
        "what": ("trained-from-scratch synthetic spacenet fixture: APLS/TOPO "
                 "scored on the SAME engine invocation whose wall time is "
                 "reported (sam_road_tpu_torch/examples/end_to_end_synthetic.py)"),
        "apls": apls,
        "topo": topo,
        "inference_time_txt": time_txt.strip(),
        "config": {"sam_version": "vit_t", "image_size": 160,
                   "patch_size": 80, "epochs": epochs},
    }
    out_path = os.environ.get("E2E_JSON_OUT", "")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(artifact, f, indent=1)
    print("E2E_ARTIFACT " + json.dumps(artifact), flush=True)

    by_epoch = {}
    for aux in trainer.history:
        by_epoch.setdefault(aux["epoch"], []).append(aux["loss"])
    steps = trainer.history[1:] or trainer.history
    return {"artifact": artifact, "seconds": seconds,
            "epoch_loss": [statistics.fmean(by_epoch[e]) for e in sorted(by_epoch)],
            "step_seconds": statistics.median(a["seconds"] for a in steps),
            "wait_seconds": statistics.median(a["data_seconds"] for a in steps),
            "launches": launches}


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
