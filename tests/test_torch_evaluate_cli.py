"""The port's evaluation CLI (python -m sam_road_tpu_torch.cli.evaluate)
against the JAX CLI (sam_road_tpu/cli/evaluate.py) on the CPU.

The graphs are the port's inference CLI's: tests/synthetic_data.py's
spacenet fixture with two test tiles, scored from a Lightning-format .ckpt
written from one init_params tree (vit_t, 64 px patches, fp32,
FUSED_ENCODER; the geometry of tests/test_torch_infer_cli.py). Both CLIs
score the same pickles, each in its own copy of the run dir, and must
write the same results/ and score/ files. The ground truth scored against
itself must come out near 1.
"""

import json
import os
import pickle
import shutil
import subprocess
import sys

import pytest
import torch

from sam_road_tpu.cli import evaluate as jevaluate
from sam_road_tpu.config import load_config as jload_config
from sam_road_tpu_torch.cli import evaluate, infer
from sam_road_tpu_torch.config import read_flat_yaml, write_flat_yaml
from sam_road_tpu_torch.models.convert import from_flax_params
from synthetic_data import make_spacenet_fixture
from test_torch_infer_cli import ENGINE, _traced_init
from test_torch_metrics import _load_jax_metrics_native, _score_files

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def inferred(tmp_path_factory):
    """The spacenet fixture (two test tiles) and the port's cli.infer run
    over it; returns the data root, the run dir and the test tile ids."""
    _load_jax_metrics_native()
    root = tmp_path_factory.mktemp("evaluate")
    data = str(root / "data")
    split = make_spacenet_fixture(data, image_size=160, spacing=40, n_test=2)
    values = read_flat_yaml(os.path.join(REPO, "configs", "toponet_vitb_256_spacenet.yaml"))
    values.update(ENGINE)
    cfg = str(root / "cfg.yaml")
    write_flat_yaml(cfg, values)
    ckpt = str(root / "samroad.ckpt")
    torch.save({"state_dict": from_flax_params(_traced_init(jload_config(cfg)))}, ckpt)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        run = infer.main(["--config", cfg, "--checkpoint", ckpt, "--device", "cpu",
                          "--data_root", data, "--output_dir", "t"])
    finally:
        os.chdir(cwd)
    return dict(data=data, run=os.path.join(str(root), run), tiles=split["test"])


def _copy_run(src, dst, tiles=None):
    """A run dir holding src's graph pickles (or those of `tiles`) only."""
    os.makedirs(os.path.join(dst, "graph"))
    for name in os.listdir(os.path.join(src, "graph")):
        if tiles is None or name[:-2] in tiles:
            shutil.copy(os.path.join(src, "graph", name), os.path.join(dst, "graph", name))
    return dst


@pytest.mark.parametrize("flags,scores", [
    ([], {"apls.json", "topo.json"}),
    (["--metric", "apls", "--no_native"], {"apls.json"}),
    (["--metric", "topo"], {"topo.json"})], ids=["all", "apls_python", "topo"])
def test_evaluate_cli_matches_jax_cli(inferred, tmp_path, flags, scores):
    runs = {}
    for name, cli in (("port", evaluate), ("jax", jevaluate)):
        run = _copy_run(inferred["run"], str(tmp_path / name))
        cli.main(["--run_dir", run, "--dataset", "spacenet", "--data_root", inferred["data"]]
                 + flags)
        runs[name] = _score_files(run)
    assert runs["port"] == runs["jax"]
    assert {os.path.basename(k) for k in runs["port"] if k.startswith("score")} == scores
    for tile in inferred["tiles"]:
        assert any(k.endswith(f"{tile}.txt") for k in runs["port"])


def test_evaluate_cli_scores_the_ground_truth_near_one(inferred, tmp_path):
    """Each tile's ground truth as its prediction: APLS > 0.97 and TOPO
    P, R and F1 > 0.97 at the spacenet parameters."""
    run = tmp_path / "gt"
    (run / "graph").mkdir(parents=True)
    for tile in inferred["tiles"]:
        shutil.copy(os.path.join(inferred["data"], "spacenet", "RGB_1.0_meter",
                                 f"{tile}__gt_graph.p"), run / "graph" / f"{tile}.p")
    evaluate.main(["--run_dir", str(run), "--dataset", "spacenet",
                   "--data_root", inferred["data"]])
    with open(run / "score" / "apls.json") as f:
        apls = json.load(f)
    with open(run / "score" / "topo.json") as f:
        topo = json.load(f)
    assert len(apls["apls"]) == 2 and min(apls["apls"]) > 0.97
    assert min(topo["prec"] + topo["recall"] + topo["f1"]) > 0.97


def test_evaluate_cli_takes_several_run_dirs_and_tiles(inferred, tmp_path):
    """Two run dirs in one call, --tiles naming one tile: each run dir's
    files equal those of a call for it alone."""
    tile = inferred["tiles"][1]
    both = [_copy_run(inferred["run"], str(tmp_path / name)) for name in ("a", "b")]
    alone = _copy_run(inferred["run"], str(tmp_path / "alone"), tiles=[tile])
    evaluate.main(["--run_dir", *both, "--dataset", "spacenet", "--data_root",
                   inferred["data"], "--tiles", tile])
    evaluate.main(["--run_dir", alone, "--dataset", "spacenet", "--data_root", inferred["data"]])
    want = _score_files(alone)
    assert len(json.loads(want["score/apls.json"])["apls"]) == 1
    assert _score_files(both[0]) == _score_files(both[1]) == want


def test_evaluate_cli_runs_as_a_module(inferred, tmp_path):
    """`python -m sam_road_tpu_torch.cli.evaluate` in a fresh interpreter
    writes what the in-process call writes, and imports no torch."""
    runs = {name: _copy_run(inferred["run"], str(tmp_path / name)) for name in ("sub", "main")}
    args = ["--dataset", "spacenet", "--data_root", inferred["data"]]
    code = ("import runpy, sys\n"
            "sys.argv = ['evaluate'] + sys.argv[1:]\n"
            "runpy.run_module('sam_road_tpu_torch.cli.evaluate', run_name='__main__')\n"
            "assert 'torch' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code, "--run_dir", runs["sub"], *args],
                          capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert f"==== evaluating {runs['sub']} ====" in proc.stdout
    evaluate.main(["--run_dir", runs["main"], *args])
    assert _score_files(runs["sub"]) == _score_files(runs["main"])
    for tile in inferred["tiles"]:
        with open(os.path.join(runs["sub"], "graph", f"{tile}.p"), "rb") as f:
            assert len(pickle.load(f)) > 10
