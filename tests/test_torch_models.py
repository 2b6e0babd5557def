"""The port's models (sam_road_tpu_torch/models) against the JAX package's
flax modules and functions, through the weight bridge, on the CPU in fp32.

Inputs come from numpy seeds and go to both sides; the Pallas kernels run in
interpret mode. Tolerance atol = rtol = 1e-4: the same math in fp32 summed
in another order (through 2-3 encoder blocks, a decoder or 3 TopoNet
layers).
"""

import subprocess
import sys
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sam_road_tpu.config import load_config as jload_config
from sam_road_tpu.models.decoder import MapDecoder as JMapDecoder
from sam_road_tpu.models.fast_encoder import encoder_forward_fused as jencoder_fused
from sam_road_tpu.models.sam_road import ModelSpec
from sam_road_tpu.models.sam_road import SAMRoad as JSAMRoad
from sam_road_tpu.models.sam_road import init_params
from sam_road_tpu.models.toponet import TopoNet as JTopoNet
from sam_road_tpu.models.vit import ENCODER_SPECS
from sam_road_tpu.models.vit import ImageEncoderViT as JImageEncoderViT
from sam_road_tpu_torch.config import load_config
from sam_road_tpu_torch.models.convert import from_flax_params, load_flax_params
from sam_road_tpu_torch.models.decoder import MapDecoder
from sam_road_tpu_torch.models.fast_encoder import encoder_forward_fused
from sam_road_tpu_torch.models.sam_road import SAMRoad
from sam_road_tpu_torch.models.toponet import TopoNet
from sam_road_tpu_torch.models.vit import ImageEncoderViT

TOL = dict(atol=1e-4, rtol=1e-4)
SMALL = dict(SAM_VERSION="vit_t", PATCH_SIZE=64, COMPUTE_DTYPE="float32",
             MAX_NEIGHBOR_QUERIES=4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _perturb(tree, seed):
    """Init leaves plus noise, so zero-initialised tables (rel-pos) and
    unit norms are exercised with generic values."""
    r = np.random.default_rng(seed)
    return jax.tree.map(lambda p: p + 0.02 * r.normal(size=p.shape).astype(p.dtype),
                        _np_tree(tree))


@pytest.fixture(scope="module")
def small_params():
    """init_params at vit_t / 64 px, traced once as one program (eager init
    dispatches op by op and takes several times longer)."""
    cfg = jload_config(overrides=SMALL)
    return _np_tree(jax.jit(lambda: init_params(cfg))())


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _vit_t_encoders(img=96, window=4, seed=9):
    spec = ENCODER_SPECS["vit_t"]
    kw = dict(img_size=img, embed_dim=spec["embed_dim"], depth=spec["depth"],
              num_heads=spec["num_heads"], global_attn_indexes=spec["global_attn_indexes"],
              window_size=window)
    jenc = JImageEncoderViT(**kw, dtype=jnp.float32)
    x = np.random.default_rng(seed).normal(size=(2, img, img, 3)).astype(np.float32)
    params = _perturb(jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"], seed + 1)
    tenc = load_flax_params(ImageEncoderViT(**kw), params, scope="image_encoder")
    return jenc, params, tenc, x


def test_bridge_consumes_every_leaf_and_fills_every_key(small_params):
    params = small_params
    model = SAMRoad.from_config(load_config(overrides=SMALL))
    state = from_flax_params(params)
    assert set(state) == set(model.state_dict())
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert len(state) == n_leaves
    load_flax_params(model, params)
    # qkv: flax Dense (in, out) -> nn.Linear (out, in)
    np.testing.assert_array_equal(
        model.image_encoder.blocks[0].attn.qkv.weight.detach().numpy(),
        params["image_encoder"]["blocks_0"]["attn"]["qkv"]["kernel"].T)


def test_bridge_raises_on_unknown_leaf_and_on_unfilled_key(small_params):
    params = small_params
    model = SAMRoad.from_config(load_config(overrides=SMALL))
    extra = {**params, "topo_net": {**params["topo_net"], "mystery": {"kernel": np.zeros((2, 2))}}}
    with pytest.raises(KeyError):
        load_flax_params(model, extra)
    missing = {**params, "map_decoder": {k: v for k, v in params["map_decoder"].items()
                                         if k != "ln_1"}}
    with pytest.raises(KeyError, match="unfilled"):
        load_flax_params(model, missing)


def test_eager_image_encoder_matches_flax():
    jenc, params, tenc, x = _vit_t_encoders()
    want = jax.jit(jenc.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tenc(torch.from_numpy(x))
    _close(got, want)


def test_fused_encoder_matches_jax_fused_encoder():
    """Plain kernel versions on CPU vs the Pallas kernels in interpret mode;
    window 4 pads the 6x6 grid to 8x8, so pad tokens are covered."""
    _, params, tenc, x = _vit_t_encoders(seed=19)
    want = jencoder_fused(params, jnp.asarray(x), sam_version="vit_t", img_size=96,
                          window_size=4, dtype=jnp.float32, interpret=True)
    got = encoder_forward_fused(tenc, torch.from_numpy(x))
    _close(got, want)


def test_map_decoder_matches_flax():
    r = np.random.default_rng(20)
    x = r.normal(size=(2, 3, 3, 256)).astype(np.float32)
    jdec = JMapDecoder(dtype=jnp.float32)
    params = _perturb(jax.jit(jdec.init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"], 21)
    want = jax.jit(jdec.apply)({"params": params}, jnp.asarray(x))
    tdec = load_flax_params(MapDecoder(), params, scope="map_decoder")
    with torch.no_grad():
        got = tdec(torch.from_numpy(x))
    assert got.shape == (2, 48, 48, 2)
    _close(got, want)


def _toponet_inputs(seed, B=2, P=12, S=5, K=4):
    r = np.random.default_rng(seed)
    points = r.uniform(0, 64, size=(B, P, 2)).astype(np.float32)
    feats = r.normal(size=(B, P, 256)).astype(np.float32)
    pairs = r.integers(0, P, size=(B, S, K, 2)).astype(np.int32)
    valid = r.random(size=(B, S, K)) < 0.6
    valid[0, 1] = False  # an all-invalid group: its mask flips
    valid[1, 3] = False
    return points, feats, pairs, valid


@pytest.mark.parametrize("version", ["normal", "no_offset", "no_transformer", "no_tgt_features"])
def test_toponet_matches_flax_including_all_invalid_groups(version):
    points, feats, pairs, valid = _toponet_inputs(22)
    jnet = JTopoNet(version=version, dtype=jnp.float32)
    args = tuple(map(jnp.asarray, (points, feats, pairs, valid)))
    params = _perturb(jax.jit(jnet.init)(jax.random.PRNGKey(2), *args)["params"], 23)
    want_logits, want_scores = jax.jit(jnet.apply)({"params": params}, *args)
    tnet = load_flax_params(TopoNet(version=version), params, scope="topo_net")
    with torch.no_grad():
        logits, scores = tnet(*map(torch.from_numpy, (points, feats, pairs, valid)))
    _close(logits, want_logits)
    _close(scores, want_scores)
    assert torch.isfinite(scores).all()


def test_samroad_inference_entry_points_match_flax(small_params):
    params = _perturb(small_params, 24)
    jmodel = JSAMRoad(ModelSpec.from_config(jload_config(overrides=SMALL)))
    model = load_flax_params(SAMRoad.from_config(load_config(overrides=SMALL)), params)
    r = np.random.default_rng(25)
    rgb = r.integers(0, 255, size=(2, 64, 64, 3)).astype(np.float32)
    want_masks, want_emb = jax.jit(partial(jmodel.apply, method=JSAMRoad.infer_masks_and_features))(
        {"params": params}, jnp.asarray(rgb))
    with torch.no_grad():
        masks, emb = model.infer_masks_and_features(torch.from_numpy(rgb))
    _close(masks, want_masks)
    _close(emb, want_emb)
    points, _, pairs, valid = _toponet_inputs(26, P=12)
    args = (np.asarray(want_emb), points, pairs, valid)
    want = jax.jit(partial(jmodel.apply, method=JSAMRoad.infer_toponet))(
        {"params": params}, *map(jnp.asarray, args))
    with torch.no_grad():
        got = model.infer_toponet(*map(torch.tensor, args))
    _close(got, want)


def test_import_and_forward_load_neither_jax_nor_the_jax_package():
    code = (
        "import sys, torch\n"
        "from sam_road_tpu_torch.config import load_config\n"
        "from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random\n"
        "from sam_road_tpu_torch.models.fast_encoder import encoder_forward_fused\n"
        "from sam_road_tpu_torch.inference.engine import TiledInferenceEngine\n"
        "from sam_road_tpu_torch.training.harness import Trainer\n"
        "from sam_road_tpu_torch.data.dataset import collate_batch\n"
        "cfg = load_config(overrides=dict(SAM_VERSION='vit_t', PATCH_SIZE=64,"
        " COMPUTE_DTYPE='float32'))\n"
        "m = init_random(SAMRoad.from_config(cfg), 0)\n"
        "with torch.no_grad():\n"
        "    masks, emb = m.infer_masks_and_features(torch.zeros(1, 64, 64, 3), encoder_forward_fused)\n"
        "assert masks.shape == (1, 64, 64, 2) and emb.shape == (1, 4, 4, 256)\n"
        "lora = load_config(overrides=dict(cfg.to_dict(), USE_SAM_DECODER=True, ENCODER_LORA=True,"
        " LORA_RANK=2))\n"
        "m = init_random(SAMRoad.from_config(lora), 0)\n"
        "assert m.use_sam_decoder and m.lora_rank == 2\n"
        "with torch.no_grad():\n"
        "    masks, emb = m.infer_masks_and_features(torch.zeros(1, 64, 64, 3))\n"
        "assert masks.shape == (1, 64, 64, 2) and emb.shape == (1, 4, 4, 256)\n"
        "engine = TiledInferenceEngine(lora, m, 'cpu')\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'sam_road_tpu'))\n"
        "print('LOADED', bad)\n"
        "assert not bad, bad\n"
    )
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=root, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout


def _config_switches():
    """The distinct (USE_SAM_DECODER, ENCODER_LORA, LORA_RANK,
    TOPONET_VERSION) of the files in configs/, read with the port's
    reader, each with the first file that holds it."""
    import glob
    import os

    from sam_road_tpu_torch.config import read_flat_yaml

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    seen = {}
    for path in sorted(glob.glob(os.path.join(root, "configs", "*.yaml"))):
        cfg = load_config(path)
        key = (bool(cfg.USE_SAM_DECODER), bool(cfg.ENCODER_LORA), int(cfg.LORA_RANK),
               str(cfg.TOPONET_VERSION))
        seen.setdefault(key, read_flat_yaml(path))
    return seen


CONFIG_SWITCHES = _config_switches()


@pytest.mark.parametrize("switches", list(CONFIG_SWITCHES), ids=lambda k: "-".join(map(str, k)))
def test_every_configs_switches_build_the_jax_models_parameters(switches):
    """Each combination of the model switches that a file in configs/
    holds builds through SAMRoad.from_config at vit_t / 64 px, with the
    state-dict names and shapes of from_flax_params of JAX's init_params
    for the same config (its shapes, by jax.eval_shape)."""
    over = dict(CONFIG_SWITCHES[switches], **SMALL)
    model = SAMRoad.from_config(load_config(overrides=over))
    cfg = jload_config(overrides=over)
    shapes = jax.eval_shape(lambda: init_params(cfg))
    want = from_flax_params(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes))
    got = model.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape)
                                                           for k, v in want.items()}
    assert model.use_sam_decoder == switches[0]
    assert model.lora_rank == (switches[2] if switches[1] else 0)
