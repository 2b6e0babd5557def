"""The port's end-to-end example (sam_road_tpu_torch/examples/
end_to_end_synthetic.py) on the CPU at a cut size (1 epoch of 2 steps):
it runs the JAX example's workflow through the port's CLIs and prints the
JAX example's artifact, with its keys; cfg_infer.yaml carries cli.test's
calibrated thresholds; E2E_JSON_OUT receives the artifact. The example
itself imports neither jax nor the JAX package."""

import ast
import contextlib
import io
import json
import os

import pytest

from sam_road_tpu_torch.examples import end_to_end_synthetic as e2e

JAX_EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples", "end_to_end_synthetic.py")


def _jax_artifact_keys() -> tuple:
    """The keys of the dict the JAX example assigns to `artifact`, and of
    its "config" entry, read from its source."""
    with open(JAX_EXAMPLE) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [getattr(t, "id", None) for t in node.targets] == ["artifact"]):
            keys = [k.value for k in node.value.keys]
            config = node.value.values[keys.index("config")]
            return tuple(keys), tuple(k.value for k in config.keys)
    raise AssertionError("no artifact dict in the JAX example")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One cut-size run of the example, with E2E_JSON_OUT set and its
    standard output captured."""
    work = tmp_path_factory.mktemp("e2e")
    out_json = work / "artifact.json"
    mp = pytest.MonkeyPatch()
    mp.setenv("E2E_JSON_OUT", str(out_json))
    cwd = os.getcwd()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            result = e2e.main(str(work / "run"), epochs=1, steps_per_epoch=2, device="cpu")
    finally:
        mp.undo()
    assert os.getcwd() == cwd
    return work, out_json, result, buf.getvalue()


def test_artifact_has_the_jax_examples_keys(run):
    _, _, result, out = run
    keys, config_keys = _jax_artifact_keys()
    assert keys == e2e.ARTIFACT_KEYS
    artifact = result["artifact"]
    assert tuple(artifact) == keys and tuple(artifact["config"]) == config_keys
    lines = [ln for ln in out.splitlines() if ln.startswith("E2E_ARTIFACT ")]
    assert len(lines) == 1 and json.loads(lines[0].removeprefix("E2E_ARTIFACT ")) == artifact
    assert artifact["config"] == {"sam_version": "vit_t", "image_size": 160, "patch_size": 80,
                                  "epochs": 1}
    assert "final_APLS" in artifact["apls"] and "f1" in artifact["topo"]
    assert artifact["inference_time_txt"].startswith("Inference completed for ")


def test_infer_config_carries_the_calibrated_thresholds(run):
    work, _, _, _ = run
    root = work / "run"
    with open(root / "thresholds.json") as f:
        thr = json.load(f)
    text = (root / "cfg_infer.yaml").read_text()
    assert f"ITSC_THRESHOLD: {thr['keypoint']['threshold']:.4f}\n" in text
    assert f"ROAD_THRESHOLD: {thr['road']['threshold']:.4f}\n" in text
    base = (root / "cfg.yaml").read_text()
    assert "ITSC_THRESHOLD: 0.37\n" in base and "ROAD_THRESHOLD: 0.57\n" in base
    assert text.replace(f"{thr['keypoint']['threshold']:.4f}", "0.37").replace(
        f"{thr['road']['threshold']:.4f}", "0.57") == base
    assert os.path.exists(root / "run" / "ckpt_epoch_0.pt")
    assert sorted(os.listdir(root / "save" / "learned" / "graph")) == ["SYN_3.p"]


def test_e2e_json_out_is_written(run):
    _, out_json, result, _ = run
    with open(out_json) as f:
        assert json.load(f) == result["artifact"]


def test_the_run_reports_its_stages(run):
    _, _, result, _ = run
    assert set(result["seconds"]) == {"fixture", "train", "test", "infer", "evaluate"}
    assert all(s > 0 for s in result["seconds"].values())
    assert len(result["epoch_loss"]) == 1 and result["epoch_loss"][0] > 0
    assert result["step_seconds"] > 0 and 0 <= result["wait_seconds"] <= result["step_seconds"]
    # CPU tensors take the plain versions: no kernel launches
    assert all(n == {} for n in result["launches"].values())
