"""The port's training measurement tools (sam_road_tpu_torch/tools/:
profile_training_feed, experiment_train_memory, sweep_train_throughput,
experiment_fused_train, profile_topo, verify_real_ckpt) on the CPU at
vit_t, 64 px patches, batch 2, fp32, held against the JAX package where
the tool computes something the JAX package computes; and K5's dispatch by
dtype (its fp32 kernel's numbers are tests/test_torch_cuda_kernels.py's,
on the card).

Tolerances:
  TOPO P / R / F1       1e-9 (the same host arithmetic on the same graphs)
  checkpoint stages     mean / std / L1 within 1e-4 relative (+ 1e-4 x the
                        stage's std for a mean near 0): the same fp32
                        encoder in two frameworks, two blocks deep
  oracle stage diff     max abs diff / std below 1e-3, the tool's own PASS
  training loss         atol = rtol = 1e-4, as
                        tests/test_torch_training.py's losses
"""

import dataclasses
import importlib.util
import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sam_road_tpu.config import load_config as jload_config
from sam_road_tpu.metrics.topo import topo_score_one_tile as jtopo_score_one_tile
from sam_road_tpu.models.sam_road import ModelSpec
from sam_road_tpu.models.sam_road import SAMRoad as JSAMRoad
from sam_road_tpu.models.sam_road import init_params
from sam_road_tpu.ops import losses as jlosses
from sam_road_tpu.training import harness as jharness
from sam_road_tpu_torch.config import load_config
from sam_road_tpu_torch.data.png import read_png
from sam_road_tpu_torch.models.convert import load_flax_params
from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random
from sam_road_tpu_torch.ops import _build, attention
from sam_road_tpu_torch.tools import (
    _fixtures,
    _train,
    experiment_fused_train,
    experiment_train_memory,
    profile_topo,
    profile_training_feed,
    sweep_train_throughput,
    verify_real_ckpt,
)
from synthetic_data import make_spacenet_fixture as jmake_spacenet_fixture
from test_torch_metrics import _load_jax_metrics_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(SAM_VERSION="vit_t", PATCH_SIZE=64, COMPUTE_DTYPE="float32", TOPO_SAMPLE_NUM=8,
            MAX_NEIGHBOR_QUERIES=4)
LOSS_TOL = dict(atol=1e-4, rtol=1e-4)


def _jax_tool(name):
    """tools/<name>.py of the JAX package, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_profile_topo_graphs_and_scores_match_jax():
    """At 512 px the port's street grids are the JAX tool's make_city_adj's,
    and the tool's P / R / F1 are JAX's topo_score_one_tile's on them."""
    _load_jax_metrics_native()
    jtool = _jax_tool("profile_topo")
    for kw in (dict(seed=0), dict(seed=1, jitter=1.5, drop_frac=0.06)):
        got, want = profile_topo.make_city_adj(size=512, **kw), jtool.make_city_adj(size=512, **kw)
        assert got == want and list(got) == list(want)
    res = profile_topo.main(512)
    want = jtopo_score_one_tile(jtool.make_city_adj(size=512, seed=0),
                                jtool.make_city_adj(size=512, seed=1, jitter=1.5,
                                                    drop_frac=0.06))
    np.testing.assert_allclose([res["precision"], res["recall"], res["f1"]], want,
                               rtol=0, atol=1e-9)
    assert res["gt_nodes"] > 0 and res["prop_nodes"] > 0 and res["seconds"] > 0
    assert 0 < res["f1"] < 1


@pytest.fixture(scope="module")
def vit_t_ckpt(tmp_path_factory):
    """A SAM-format vit_t .pth from seeded weights at 1024 px geometry (the
    64 x 64 pos embed and 127-row global rel-pos tables), as
    chip_smoke.py::write_sam_checkpoint writes one, scaled by 0.02 as
    tests/test_sam_ckpt_conversion.py scales its fake."""
    model = init_random(SAMRoad.from_config(load_config(overrides=dict(
        TINY, PATCH_SIZE=1024))), 5)
    state = {f"image_encoder.{k}": v * 0.02 for k, v in model.image_encoder.state_dict().items()}
    path = str(tmp_path_factory.mktemp("ckpt") / "sam_vit_t_fake.pth")
    torch.save(state, path)
    return path


def test_verify_real_ckpt_stages_match_jax(vit_t_ckpt):
    """The port's per-stage mean / std / L1 are the JAX tool's run() rows
    (oracle off), with the same match counts."""
    lines = []
    got = verify_real_ckpt.run(vit_t_ckpt, "vit_t", 64, device="cpu", out=lines.append)
    want = _jax_tool("verify_real_ckpt").run(vit_t_ckpt, "vit_t", 64, oracle=False,
                                             out=lambda *a: None)
    assert [r["stage"] for r in got["rows"]] == [r["stage"] for r in want]
    for g, w in zip(got["rows"], want):
        assert tuple(g["shape"]) == tuple(w["shape"]), g["stage"]
        for key in ("mean", "std", "l1"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, atol=1e-4 * w["std"],
                                       err_msg=f"{g['stage']} {key}")
    _, jmatched, jmismatched = _jax_convert_counts(vit_t_ckpt)
    assert (got["matched"], got["mismatched"]) == (jmatched, jmismatched)
    assert got["buckets"]["matched"] == {"image_encoder": got["matched"]}
    assert got["worst"] is None and any("matched params" in line for line in lines)


def _jax_convert_counts(path):
    from sam_road_tpu.models.convert import load_and_convert as jload_and_convert

    tree, matched, mismatched = jload_and_convert(
        path, jload_config(overrides=dict(TINY, SAM_VERSION="vit_t")))
    return tree, len(matched), len(mismatched)


def test_verify_real_ckpt_oracle_passes(vit_t_ckpt):
    """With the oracle: every stage against the torch oracle encoder within
    the tool's 1e-3 of the stage's std."""
    lines = []
    got = verify_real_ckpt.run(vit_t_ckpt, "vit_t", 64, oracle=True, device="cpu",
                               out=lines.append)
    assert got["worst"] is not None and got["worst"] < 1e-3
    assert set(got["oracle_rel_diff"]) == {"block_0", "block_1", "neck"}
    assert "PASS" in lines[-1]


@pytest.fixture(scope="module")
def jax_tree():
    """JAX init_params at the fused-train tool's config cut to TINY."""
    cfg = jload_config(experiment_fused_train.CONFIG, overrides=TINY)
    return jax.tree.map(np.asarray, jax.jit(lambda: init_params(cfg))())


def test_experiment_fused_train_first_loss_matches_jax(jax_tree):
    """Both arms start from JAX init_params carried across: the eager arm's
    first-step loss (dropout off) is the JAX forward's loss on the same
    batch, and the fused arm's (K6's plain versions here) is the eager
    arm's."""
    base = experiment_fused_train.CONFIG
    model = load_flax_params(SAMRoad.from_config(load_config(base, overrides=TINY)), jax_tree)
    res = experiment_fused_train.main(steps=1, rounds=1, batch=2, device="cpu", overrides=TINY,
                                      model=model, deterministic=True)
    jcfg = jload_config(base, overrides=dict(TINY, BATCH_SIZE=2))
    jmodel = JSAMRoad(dataclasses.replace(ModelSpec.from_config(jcfg), flash_attention="always"))
    jb = jharness._materialize_batch({k: jnp.asarray(v) for k, v in
                                      _train.fake_batch(load_config(base, overrides=TINY),
                                                        2).items()})
    ml, _, tl, _ = jmodel.apply({"params": jax_tree}, jb["rgb"], jb["graph_points"], jb["pairs"],
                                jb["valid"], deterministic=True)
    gt = jnp.stack([jb["keypoint_mask"], jb["road_mask"]], axis=3)
    want = float(jlosses.bce_with_logits(ml, gt)
                 + jlosses.masked_topo_loss(tl, jb["connected"], jb["valid"]))
    np.testing.assert_allclose(res["warmup_losses"]["eager"], want, **LOSS_TOL)
    np.testing.assert_allclose(res["warmup_losses"]["fused"], res["warmup_losses"]["eager"],
                               **LOSS_TOL)
    for arm in ("eager", "fused"):
        assert len(res[arm]["losses"]) == 2 and np.isfinite(res[arm]["grad_norms"]).all()
        assert all(v > 0 for v in res[arm]["moved"].values())
    assert res["speedup"] == res["eager_min"] / res["fused_min"]


def test_experiment_train_memory_counts_the_step_state():
    """arg_mb is the parameters, Adam's two moments and step count, and the
    device batch, counted here from the config alone; the peaks are None on
    the CPU; one row per FLASH_ATTENTION x REMAT_ENCODER."""
    res = experiment_train_memory.main(2, "cpu", overrides=TINY)
    cfg = load_config(overrides={**experiment_train_memory.GEOMETRY, "BATCH_SIZE": 2, **TINY})
    model = SAMRoad.from_config(cfg)
    params = sum(p.numel() for p in model.parameters()) * 4
    adam = sum(2 * p.numel() * 4 + 4 for p in model.parameters())
    b = _train.fake_batch(cfg, 2)
    batch = sum(v.size * (4 if k in ("rgb", "keypoint_mask", "road_mask") else v.itemsize)
                for k, v in b.items())
    assert set(res) == {"device", "flash1_remat1", "flash1_remat0", "flash0_remat1",
                        "flash0_remat0"}
    for label, row in res.items():
        if label == "device":
            continue
        assert row["arg_mb"] * 2 ** 20 == params + adam + batch, label
        assert row["peak_mb"] is None and row["temp_mb"] is None and row["out_mb"] == 0.0
        assert len(row["losses"]) == 2 and np.isfinite(row["losses"]).all()
        assert row["skipped"] == 0


def test_sweep_train_throughput_rows():
    """One row per (batch, remat), finite losses, patches_per_s = batch /
    s_per_step, and the best row the fastest."""
    res = sweep_train_throughput.main(1, "cpu", batches=(2, 4), overrides=TINY)
    rows = res["rows"]
    assert [(r["batch"], r["remat"]) for r in rows] == [(2, False), (2, True), (4, False),
                                                        (4, True)]
    for r in rows:
        assert r["loss_finite"] and r["s_per_step"] > 0 and r["peak_gib"] is None
        assert r["patches_per_s"] == r["batch"] / r["s_per_step"]
        assert r["config"] == f"B{r['batch']}_remat{int(r['remat'])}"
    assert res["best"] == max(rows, key=lambda r: r["patches_per_s"])


def test_feed_fixture_writes_the_test_fixture(tmp_path):
    """The port's SpaceNet fixture writes the files of
    tests/synthetic_data.make_spacenet_fixture: the split file and the GT
    pickles byte-equal, every tile and mask pixel-equal (cv2's PNG
    encoding differs from write_png's, the pixels do not)."""
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    kw = dict(image_size=160, n_train=2, n_val=1, n_test=1, spacing=40)
    assert _fixtures.make_spacenet_fixture(str(mine), **kw) == jmake_spacenet_fixture(
        str(theirs), **kw)
    files = sorted(p.relative_to(theirs) for p in theirs.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(mine) for p in mine.rglob("*") if p.is_file())
    assert len(files) == 4 * 2 + 4 * 2 + 1
    for rel in files:
        a, b = (mine / rel), (theirs / rel)
        if rel.suffix == ".png":
            x, y = read_png(str(a)), read_png(str(b))
            assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), rel
        else:
            assert a.read_bytes() == b.read_bytes(), rel
    assert json.loads((mine / "spacenet" / "data_split.json").read_text())["test"] == ["SYN_3"]
    with open(mine / "spacenet" / "RGB_1.0_meter" / "SYN_0__gt_graph.p", "rb") as f:
        assert pickle.load(f) == _fixtures.make_grid_graph_rc(160, 40)


def test_profile_training_feed_small(tmp_path):
    """A 160 px fixture at 1 and 2 workers, 2 batches each: finite, positive
    rates and loader waits, and the saturation of the larger count."""
    res = profile_training_feed.main(
        "cpu", root=str(tmp_path), image_size=160, spacing=40, batch=2,
        overrides=dict(TINY), device_steps=2, fed_batches=2, workers=(1, 2))
    for key in ("device_step_ms", "device_steps_per_s", "steps_per_s_1w", "steps_per_s_2w",
                "saturation_pct_2w"):
        assert np.isfinite(res[key]) and res[key] > 0, key
    for w in (1, 2):
        assert res[f"loader_wait_s_{w}w"] >= 0
        assert res[f"loader_wait_per_step_s_{w}w"] == res[f"loader_wait_s_{w}w"]  # one step
    assert res["device"] == "cpu"


def test_fused_attention_fp32_on_the_cpu_runs_the_plain_version(monkeypatch):
    """On CPU tensors K5 in fp32 (and bf16) is its plain version, and no
    kernel is built or counted."""
    calls = []
    plain = attention.fused_attention_plain
    monkeypatch.setattr(attention, "fused_attention_plain",
                        lambda *a: calls.append(a[0].dtype) or plain(*a))
    monkeypatch.setattr(_build, "kernels", lambda: pytest.fail("built a kernel on the CPU"))
    r = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(r.normal(size=(1, 2, 196, s)).astype(np.float32))
               for s in (96, 96, 64))
    before = dict(_build.launches)
    out = attention.fused_attention(q, k, v)
    out16 = attention.fused_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert calls == [torch.float32, torch.bfloat16]
    assert out.dtype == torch.float32 and out16.dtype == torch.bfloat16
    torch.testing.assert_close(out, plain(q, k, v), rtol=0, atol=0)
    assert dict(_build.launches) == before


class _FakeLib:
    """Records which C entry point a wrapper calls (for the dispatch test)."""

    def __init__(self):
        self.called = []

    def __getattr__(self, name):
        return lambda *args: self.called.append((name, args[4:8])) or 0


@pytest.mark.parametrize("dtype,entry,name", [
    (torch.bfloat16, "samroad_folded_attention", "fused_attention"),
    (torch.float32, "samroad_folded_attention_f32", "fused_attention_f32"),
])
def test_fused_attention_dispatches_on_dtype(monkeypatch, dtype, entry, name):
    """On the card's path (the CPU check patched away, the library faked),
    bf16 goes to the MODE_FOLDED entry and fp32 to folded_attention_f32's,
    each counted under its own name with the (B·H, N, D, dv) it launches
    at; fp16 raises TypeError before any kernel is built."""
    lib = _FakeLib()
    monkeypatch.setattr(_build, "on_cpu", lambda t: False)
    monkeypatch.setattr(_build, "require", lambda *a, **k: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "kernels", lambda: lib)
    q = torch.zeros((2, 3, 196, 96), dtype=dtype)
    v = torch.zeros((2, 3, 196, 64), dtype=dtype)
    before = dict(_build.launches)
    out = attention.fused_attention(q, q, v)
    assert out.dtype == dtype and out.shape == v.shape
    assert lib.called == [(entry, (6, 196, 96, 64))]
    assert _build.launches[name] == before.get(name, 0) + 1
    other = "fused_attention" if name == "fused_attention_f32" else "fused_attention_f32"
    assert _build.launches[other] == before.get(other, 0)
    monkeypatch.setattr(_build, "kernels", lambda: pytest.fail("built a kernel for fp16"))
    with pytest.raises(TypeError, match="bf16 or fp32"):
        attention.fused_attention(q.half(), q.half(), v.half())
