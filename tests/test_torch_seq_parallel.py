"""The port's sequence-parallel encoder (parallel/seq_parallel.py) against
the JAX package's encoder_forward_sp on the CPU, at fp32 on the geometry of
tests/test_seq_parallel.py: embed 64, depth 2, 2 heads, window 4, block 1
global. The JAX side runs on the 8-device CPU mesh of tests/conftest.py;
the port's mesh repeats the one CPU device. Tolerance: atol 2e-5, the JAX
test's own bound against the flax encoder (the same fp32 math per token,
summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_road_tpu.models.vit import ImageEncoderViT as JImageEncoderViT
from sam_road_tpu.parallel.mesh import make_mesh as jmake_mesh
from sam_road_tpu.parallel.seq_parallel import encoder_forward_sp as jencoder_forward_sp
from sam_road_tpu_torch.models.convert import load_flax_params
from sam_road_tpu_torch.models.vit import ImageEncoderViT
from sam_road_tpu_torch.parallel import make_mesh
from sam_road_tpu_torch.parallel.seq_parallel import encoder_forward_sp, make_sp_encoder_body

ATOL = 2e-5
KW = dict(embed_dim=64, depth=2, num_heads=2, window_size=4, global_attn_indexes=(1,))


def _geometry(img_size):
    """Perturbed flax weights (nonzero rel-pos tables) and an input, as the
    JAX test draws them, with the port's encoder holding the same
    weights."""
    jenc = JImageEncoderViT(img_size=img_size, use_flash=False, dtype=jnp.float32, **KW)
    x = np.random.default_rng(0).normal(size=(2, img_size, img_size, 3)).astype(np.float32)
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(
        lambda p: p + 0.05 * np.random.default_rng(1).normal(size=p.shape).astype(np.float32),
        jax.tree.map(np.asarray, params))
    tenc = load_flax_params(ImageEncoderViT(img_size=img_size, use_flash=False, **KW), params,
                            scope="image_encoder")
    return params, tenc, x


@pytest.fixture(scope="module")
def aligned():
    return _geometry(128)  # grid 8, window 4: no window padding


@pytest.fixture(scope="module")
def padded():
    return _geometry(96)  # grid 6, window 4: windows padded to 8


def _both(geometry, img_size, n):
    params, tenc, x = geometry
    want = jencoder_forward_sp(params, jnp.asarray(x), jmake_mesh(n, jax.devices()[:n]),
                               sam_version="vit_t", img_size=img_size, window_size=4,
                               dtype=jnp.float32)
    with torch.no_grad():
        got = encoder_forward_sp(tenc, torch.from_numpy(x), make_mesh(n, ["cpu"] * n),
                                 sam_version="vit_t", img_size=img_size, window_size=4)
        eager = tenc(torch.from_numpy(x))
    return np.asarray(want), got.numpy(), eager.numpy()


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sp_encoder_matches_jax_aligned_grid(aligned, n):
    want, got, eager = _both(aligned, 128, n)
    assert got.shape == (2, 8, 8, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, eager, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n", [1, 2])
def test_sp_encoder_matches_jax_padded_windows(padded, n):
    """6 grid rows divide over 1 and 2 shards; 4 windows over 2 shards, and
    over 1 with 4 windows a shard."""
    want, got, eager = _both(padded, 96, n)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, eager, rtol=0, atol=ATOL)


def test_sp_encoder_pads_windows_to_the_mesh(aligned):
    """4 windows an image over 8 row bands of one row: the window list is
    padded to 8, one window a shard, and shards 4-7 compute only padding."""
    want, got, _ = _both(aligned, 128, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_sp_encoder_rejects_nondivisible_grid(padded):
    """grid 6 over 4 shards: the divisibility error, before any work."""
    _, tenc, x = padded
    with pytest.raises(ValueError, match="must divide"):
        encoder_forward_sp(tenc, torch.from_numpy(x), make_mesh(4, ["cpu"] * 4),
                           sam_version="vit_t", img_size=96, window_size=4)
    with pytest.raises(ValueError, match="must divide"):
        make_sp_encoder_body(sam_version="vit_t", img_size=96, window_size=4, n=4)
