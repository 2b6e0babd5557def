"""The port's checkpoint loading, graph and viz writers, and its inference
and calibration CLIs (python -m sam_road_tpu_torch.cli.infer / .cli.test)
against the JAX package on the CPU.

- load_and_convert and load_mae_encoder_params on small fake checkpoints at
  vit_t with PATCH_SIZE 64 (the pos-embed resize engaged): the port's state
  dict equals from_flax_params of JAX's merged tree exactly, with the same
  matched and mismatched names.
- convert_to_sat2graph_format and filter_nodes: equal to JAX's.
- visualize_image_and_graph against JAX's cv2 drawing: the drawn pixels
  equal (utils/viz.py draws what cv2 draws, exactly), the resized
  background equal at the tile's own size and within 1 level otherwise.
- Both CLIs against the JAX CLIs on tests/synthetic_data.py's spacenet
  fixture, with a Lightning-format .ckpt written from one init_params tree
  (vit_t, 64 px patches, fp32, FUSED_ENCODER): masks within 1 uint8 level,
  the same graph pickles, the same threshold JSON.
"""

import json
import os
import pickle

import cv2
import numpy as np
import pytest
import torch

import jax

from sam_road_tpu.cli import infer as jinfer
from sam_road_tpu.cli import test as jtest
from sam_road_tpu.config import load_config as jload_config
from sam_road_tpu.graph.convert import convert_to_sat2graph_format as jconvert
from sam_road_tpu.graph.convert import filter_nodes as jfilter_nodes
from sam_road_tpu.models import convert as jconvert_module
from sam_road_tpu.models import sam_road as jsam_road
from sam_road_tpu.models.sam_road import init_params
from sam_road_tpu.utils.viz import visualize_image_and_graph as jviz
from sam_road_tpu_torch.cli import infer, test
from sam_road_tpu_torch.config import load_config, read_flat_yaml, write_flat_yaml
from sam_road_tpu_torch.data.png import read_png
from sam_road_tpu_torch.graph.convert import convert_to_sat2graph_format, filter_nodes
from sam_road_tpu_torch.models import convert
from sam_road_tpu_torch.models.convert import _torch_name, from_flax_params, load_flax_params
from sam_road_tpu_torch.models.sam_road import SAMRoad
from sam_road_tpu_torch.utils.viz import EDGE_BGR, NODE_BGR, visualize_image_and_graph
from synthetic_data import make_spacenet_fixture
from test_torch_engine import _load_jax_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(SAM_VERSION="vit_t", PATCH_SIZE=64, COMPUTE_DTYPE="float32", MAX_NEIGHBOR_QUERIES=4)


def _fake_sam_state_dict(seed, dim=64, depth=2, heads=2, global_idx=(1,)):
    """A SAM checkpoint's layout at 1024 px geometry (64x64 pos embed,
    127-row global rel-pos tables), at vit_t's widths, with a few
    prompt-encoder and mask-decoder entries as real checkpoints carry."""
    g = torch.Generator().manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g)

    hd = dim // heads
    sd = {"image_encoder.pos_embed": rn(1, 64, 64, dim),
          "image_encoder.patch_embed.proj.weight": rn(dim, 3, 16, 16),
          "image_encoder.patch_embed.proj.bias": rn(dim)}
    for i in range(depth):
        p = f"image_encoder.blocks.{i}"
        for name, shape in (("norm1.weight", (dim,)), ("norm1.bias", (dim,)),
                            ("norm2.weight", (dim,)), ("norm2.bias", (dim,)),
                            ("attn.qkv.weight", (3 * dim, dim)), ("attn.qkv.bias", (3 * dim,)),
                            ("attn.proj.weight", (dim, dim)), ("attn.proj.bias", (dim,)),
                            ("mlp.lin1.weight", (4 * dim, dim)), ("mlp.lin1.bias", (4 * dim,)),
                            ("mlp.lin2.weight", (dim, 4 * dim)), ("mlp.lin2.bias", (dim,))):
            sd[f"{p}.{name}"] = rn(*shape)
        size = 127 if i in global_idx else 27
        sd[f"{p}.attn.rel_pos_h"] = rn(size, hd)
        sd[f"{p}.attn.rel_pos_w"] = rn(size, hd)
    for name, shape in (("neck.0.weight", (256, dim, 1, 1)), ("neck.1.weight", (256,)),
                        ("neck.1.bias", (256,)), ("neck.2.weight", (256, 256, 3, 3)),
                        ("neck.3.weight", (256,)), ("neck.3.bias", (256,))):
        sd[f"image_encoder.{name}"] = rn(*shape)
    sd["prompt_encoder.no_mask_embed.weight"] = rn(1, 256)
    sd["mask_decoder.iou_token.weight"] = rn(1, 256)
    return sd


_INITS: dict = {}


def _traced_init(config):
    """init_params(config), traced once per config."""
    key = tuple(sorted((k, str(v)) for k, v in config.items()))
    if key not in _INITS:
        _INITS[key] = jax.tree.map(np.asarray, jax.jit(lambda: init_params(config))())
    return _INITS[key]


@pytest.fixture(scope="module", autouse=True)
def traced_jax_init():
    """The JAX converter and CLIs call init_params eagerly (~15 s on the
    CPU): they get the traced one, so both sides start from one tree."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsam_road, "init_params", _traced_init)
        yield


@pytest.fixture(scope="module")
def jax_init():
    """JAX's init_params tree at SMALL."""
    return _traced_init(jload_config(overrides=SMALL))


def _port_model_from(tree):
    return load_flax_params(SAMRoad.from_config(load_config(overrides=SMALL)), tree)


def _assert_same_load(got, want_tree, matched, mismatched, want_matched, want_mismatched):
    want = from_flax_params(want_tree)
    state = got.state_dict()
    assert set(state) == set(want)
    for k, v in want.items():
        assert torch.equal(state[k], v), k
    assert sorted(matched) == sorted(_torch_name(tuple(n.split(".")))[0] for n in want_matched)
    assert sorted(mismatched) == sorted(_torch_name(tuple(n.split(".")))[0]
                                        for n in want_mismatched)


def test_load_and_convert_matches_jax_with_the_resize(tmp_path, jax_init):
    path = str(tmp_path / "sam_fake.pth")
    torch.save(_fake_sam_state_dict(0), path)
    cfg = SMALL
    want_tree, want_matched, want_mismatched = jconvert_module.load_and_convert(
        path, jload_config(overrides=cfg))
    model, matched, mismatched = convert.load_and_convert(
        path, load_config(overrides=cfg), model=_port_model_from(jax_init))
    assert model.image_encoder.pos_embed.shape == (1, 4, 4, 64)  # resized 64 -> 4
    assert model.image_encoder.blocks[1].attn.rel_pos_h.shape == (7, 32)
    assert all(n.startswith(("map_decoder", "topo_net")) for n in mismatched)
    assert len(matched) == sum(1 for k in model.state_dict() if k.startswith("image_encoder"))
    _assert_same_load(model, want_tree, matched, mismatched, want_matched, want_mismatched)


def test_load_mae_encoder_params_matches_jax(tmp_path, jax_init):
    sd = _fake_sam_state_dict(1)
    mae = {k[len("image_encoder."):].replace(".mlp.lin", ".mlp.fc"): v for k, v in sd.items()
           if k.startswith("image_encoder.") and "rel_pos" not in k and "neck" not in k}
    mae["pos_embed"] = torch.randn(1, 197, 64)  # with a cls token: never transferred
    mae["cls_token"] = torch.randn(1, 1, 64)
    path = str(tmp_path / "mae_fake.pth")
    torch.save({"model": mae}, path)
    cfg = {**SMALL, "NO_SAM": True}
    want_tree, want_matched, want_mismatched = jconvert_module.load_mae_encoder_params(
        path, jload_config(overrides=cfg))
    model, matched, mismatched = convert.load_mae_encoder_params(
        path, load_config(overrides=cfg), model=_port_model_from(jax_init))
    assert "image_encoder.pos_embed" in mismatched
    assert "image_encoder.blocks.0.mlp.lin1.weight" in matched
    _assert_same_load(model, want_tree, matched, mismatched, want_matched, want_mismatched)


def test_load_checkpoint_is_strict_and_directories_raise(tmp_path, jax_init):
    model = _port_model_from(jax_init)
    path = str(tmp_path / "ckpt_epoch_0.pt")
    torch.save({"model": model.state_dict(), "step": 7}, path)
    fresh = SAMRoad.from_config(load_config(overrides=SMALL))
    assert convert.load_checkpoint(path, fresh) == 7
    assert all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(),
                                                 model.state_dict().values()))
    partial = {k: v for k, v in model.state_dict().items() if not k.startswith("topo_net")}
    torch.save({"model": partial, "step": 1}, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        convert.load_checkpoint(path, fresh)
    with pytest.raises(IsADirectoryError, match="orbax"):
        convert.load_weights(str(tmp_path), load_config(overrides=SMALL))
    with pytest.raises(ValueError, match="Trainer"):
        sam = str(tmp_path / "sam.pth")
        torch.save(_fake_sam_state_dict(2), sam)
        convert.load_checkpoint(sam, fresh)


def test_graph_converters_match_jax():
    r = np.random.default_rng(40)
    nodes = r.uniform(0, 400, (60, 2))
    edges = r.integers(0, 60, (90, 2))
    got, want = convert_to_sat2graph_format(nodes, edges), jconvert(nodes, edges)
    assert pickle.dumps(got) == pickle.dumps(want)
    assert convert_to_sat2graph_format(np.zeros((0, 2)), np.zeros((0, 2), int)) == {}
    keep = r.random(60) < 0.6
    for a, b in zip(filter_nodes(nodes, edges, keep), jfilter_nodes(nodes, edges, keep)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size,viz_size", [(160, 160), (400, 400), (200, 256)])
def test_visualize_image_and_graph_matches_cv2(size, viz_size):
    """Nodes past the edges of the image too. Over a black tile the two
    overlays are equal everywhere (the drawing alone); over a random tile
    they are equal on those drawn pixels, and elsewhere at the same size,
    while at another viz size the bilinear resize differs from cv2's fixed
    point by at most 1 level."""
    r = np.random.default_rng(size)
    img = r.integers(0, 255, (size, size, 3), dtype=np.uint8)
    nodes = r.uniform(-0.02, 1.02, (40, 2))
    edges = r.integers(0, 40, (60, 2))
    black = np.zeros_like(img)
    want_drawn = jviz(black.copy(), nodes, edges, viz_size)
    got_drawn = visualize_image_and_graph(black, nodes, edges, viz_size)
    np.testing.assert_array_equal(got_drawn, want_drawn)
    drawn = want_drawn.any(-1)
    assert drawn.any() and (want_drawn == EDGE_BGR).all(-1).any()
    assert (want_drawn == NODE_BGR).all(-1).any()
    want = jviz(img.copy(), nodes, edges, viz_size)
    got = visualize_image_and_graph(img, nodes, edges, viz_size)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got[drawn], want[drawn])
    diff = np.abs(got[~drawn].astype(int) - want[~drawn].astype(int)).max()
    assert diff == 0 if size == viz_size else diff <= 1


# ---------------------------------------------------------------- the CLIs

ENGINE = dict(IMAGE_SIZE=160, SAM_VERSION="vit_t", PATCH_SIZE=64, INFER_BATCH_SIZE=8,
              INFER_PATCHES_PER_EDGE=4, SAMPLE_MARGIN=8, COMPUTE_DTYPE="float32",
              ITSC_THRESHOLD=0.9, ROAD_THRESHOLD=0.45, TOPO_THRESHOLD=0.4, ITSC_NMS_RADIUS=4,
              ROAD_NMS_RADIUS=8, NEIGHBOR_RADIUS=24, MAX_NEIGHBOR_QUERIES=4, FUSED_ENCODER=True,
              TOPO_SAMPLE_NUM=8, BATCH_SIZE=2, DP_SHARDS=0)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """The spacenet fixture, a config and a Lightning-format .ckpt written
    from one init_params tree."""
    root = tmp_path_factory.mktemp("cli")
    data = str(root / "data")
    make_spacenet_fixture(data, image_size=160, spacing=40)
    values = read_flat_yaml(os.path.join(REPO, "configs", "toponet_vitb_256_spacenet.yaml"))
    values.update(ENGINE)
    cfg = str(root / "cfg.yaml")
    write_flat_yaml(cfg, values)
    params = _traced_init(jload_config(cfg))
    ckpt = str(root / "samroad.ckpt")
    torch.save({"state_dict": from_flax_params(params), "epoch": 3}, ckpt)
    return dict(root=root, data=data, cfg=cfg, ckpt=ckpt, params=params)


def _read_outputs(out_dir, test_ids):
    masks = {f"{i}_{kind}": read_png(os.path.join(out_dir, "mask", f"{i}_{kind}.png"))
             for i in test_ids for kind in ("road", "itsc")}
    graphs = {}
    for i in test_ids:
        with open(os.path.join(out_dir, "graph", f"{i}.p"), "rb") as f:
            graphs[i] = f.read()
    return masks, graphs


@pytest.fixture(scope="module")
def jax_infer(fixture, tmp_path_factory):
    """The JAX CLI's outputs, with its native NMS and kNN pairs loaded
    (their scipy fallback breaks distance ties differently)."""
    _load_jax_native()
    run = tmp_path_factory.mktemp("jax_infer")
    cwd = os.getcwd()
    os.chdir(run)
    try:
        jinfer.main(["--config", fixture["cfg"], "--checkpoint", fixture["ckpt"],
                     "--data_root", fixture["data"], "--output_dir", "j"])
    finally:
        os.chdir(cwd)
    return str(run / "save" / "j")


def test_infer_cli_matches_jax_cli(fixture, jax_infer, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = infer.main(["--config", fixture["cfg"], "--checkpoint", fixture["ckpt"], "--device",
                      "cpu", "--data_root", fixture["data"], "--output_dir", "t"])
    assert out == "./save/t"
    with open(os.path.join(fixture["data"], "spacenet", "data_split.json")) as f:
        test_ids = json.load(f)["test"]
    got_masks, got_graphs = _read_outputs(out, test_ids)
    want_masks, want_graphs = _read_outputs(jax_infer, test_ids)
    for k, want in want_masks.items():
        assert got_masks[k].shape == want.shape == (160, 160)
        assert np.abs(got_masks[k].astype(int) - want.astype(int)).max() <= 1, k
    assert got_graphs == want_graphs
    assert all(len(pickle.loads(g)) > 10 for g in got_graphs.values())
    for i in test_ids:  # the viz file decodes (cv2 and ours) to the drawn BGR image
        viz = cv2.imread(os.path.join(out, "viz", f"{i}.png"))
        assert viz.shape == (160, 160, 3)
        np.testing.assert_array_equal(viz, read_png(os.path.join(out, "viz", f"{i}.png"))[..., ::-1])
    assert sorted(os.listdir(out)) == sorted(os.listdir(jax_infer))
    with open(os.path.join(out, "inference_time.txt")) as f:
        assert f.read().startswith(f"Inference completed for {fixture['cfg']} in ")
    assert read_flat_yaml(os.path.join(out, "config.yaml")) == load_config(fixture["cfg"]).to_dict()


def test_infer_cli_takes_the_ports_own_checkpoint(fixture, jax_infer, tmp_path, monkeypatch):
    """A ckpt_epoch_N.pt of the same weights (load_checkpoint's format)
    gives the .ckpt run's outputs; --device cuda without a GPU and the
    multi-device keys raise."""
    monkeypatch.chdir(tmp_path)
    model = load_flax_params(SAMRoad.from_config(load_config(fixture["cfg"])), fixture["params"])
    pt = str(tmp_path / "ckpt_epoch_0.pt")
    torch.save({"model": model.state_dict(), "optimizer": {}, "step": 2, "epoch": 0}, pt)
    out = infer.main(["--config", fixture["cfg"], "--checkpoint", pt, "--device", "cpu",
                      "--data_root", fixture["data"], "--output_dir", "pt"])
    with open(os.path.join(fixture["data"], "spacenet", "data_split.json")) as f:
        test_ids = json.load(f)["test"]
    got_masks, got_graphs = _read_outputs(out, test_ids)
    want_masks, want_graphs = _read_outputs(jax_infer, test_ids)
    assert got_graphs == want_graphs
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            infer.main(["--config", fixture["cfg"], "--checkpoint", pt])
    # the multi-device keys build a mesh of CUDA devices: with none visible
    # (--device cpu) they raise and name the count, where JAX would run on
    # one device; both together raise as JAX asserts
    for keys, error, match in ((dict(DP_SHARDS=2), RuntimeError, "2 CUDA devices, but 0"),
                               (dict(SP_SHARDS=1), RuntimeError, "1 CUDA devices, but 0"),
                               (dict(DP_SHARDS=2, SP_SHARDS=2), ValueError, "exclusive")):
        values = read_flat_yaml(fixture["cfg"])
        values.update(keys)
        cfg = str(tmp_path / f"{'_'.join(keys)}.yaml")
        write_flat_yaml(cfg, values)
        with pytest.raises(error, match=match):
            infer.main(["--config", cfg, "--checkpoint", pt, "--device", "cpu"])


def test_test_cli_matches_jax_cli(fixture, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    args = ["--config", fixture["cfg"], "--checkpoint", fixture["ckpt"], "--dev_run",
            "--data_root", fixture["data"]]
    jtest.main(args + ["--output_json", "j.json"])
    want_out = capsys.readouterr().out
    got = test.main(args + ["--output_json", "t.json", "--device", "cpu"])
    got_out = capsys.readouterr().out
    with open("j.json") as f:
        want = json.load(f)
    with open("t.json") as f:
        assert json.load(f) == want == json.loads(json.dumps(got))
    assert set(want) == {"keypoint", "road", "topo"}
    lines = [line for line in want_out.splitlines() if line.startswith(("=", "Best"))]
    assert [line for line in got_out.splitlines() if line.startswith(("=", "Best"))] == lines
