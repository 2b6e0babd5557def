"""The port's host data path (sam_road_tpu_torch: data/png.py, the flat
YAML config reader, graph/, data/graph_labels.py, data/dataset.py) against
cv2, PyYAML and the JAX package on the CPU.

Everything here is exact: decoded pixels equal cv2.imread's, configs equal
yaml.safe_load's, and graphs, labels, samples and batches are byte-equal to
the JAX package's for the same np.random.default_rng seeds. The JAX side
runs its native NMS (tests/test_torch_engine.py::_load_jax_native): its
scipy fallback would pick other survivors.
"""

import glob
import importlib.util
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import yaml

from sam_road_tpu.config import load_config as jload_config
from sam_road_tpu.data import dataset as jdataset
from sam_road_tpu.data.graph_labels import GraphLabelGenerator as JGraphLabelGenerator
from sam_road_tpu.graph import convert as jconvert
from sam_road_tpu.graph import geometry as jgeometry
from sam_road_tpu.graph import spatial as jspatial
from sam_road_tpu.graph import structure as jstructure
from sam_road_tpu_torch import config as tconfig
from sam_road_tpu_torch.data import dataset, png
from sam_road_tpu_torch.data.graph_labels import GraphLabelGenerator
from sam_road_tpu_torch.graph import convert, geometry, spatial, structure
from synthetic_data import make_grid_graph_rc, make_spacenet_fixture
from test_torch_engine import _load_jax_native

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
SPACENET = dict(DATASET="spacenet", IMAGE_SIZE=160, PATCH_SIZE=80, TOPO_SAMPLE_NUM=8,
                MAX_NEIGHBOR_QUERIES=4, NEIGHBOR_RADIUS=48, ROAD_NMS_RADIUS=16, BATCH_SIZE=2)
CITYSCALE = dict(DATASET="cityscale", IMAGE_SIZE=256, PATCH_SIZE=64, TOPO_SAMPLE_NUM=16,
                 MAX_NEIGHBOR_QUERIES=4, NEIGHBOR_RADIUS=48, ROAD_NMS_RADIUS=8, BATCH_SIZE=3)


@pytest.fixture(autouse=True, scope="module")
def jax_native():
    _load_jax_native()


def _chip_smoke():
    """chip_smoke.py, whose Cityscale-format fixture writer (the 8 tiles
    --dev_run reads, written with png.write_png) these tests reuse."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(CONFIG_DIR), "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _crossing_graph(seed, size=256, n_nodes=24, n_edges=30):
    """A random sat2graph dict whose straight edges cross each other."""
    r = np.random.default_rng(seed)
    nodes = [tuple(int(v) for v in p) for p in r.integers(8, size - 8, (n_nodes, 2))]
    adj = {}
    for _ in range(n_edges):
        a, b = r.choice(n_nodes, 2, replace=False)
        if nodes[a] != nodes[b]:
            adj.setdefault(nodes[a], []).append(nodes[b])
            adj.setdefault(nodes[b], []).append(nodes[a])
    return adj


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    spacenet = str(tmp_path_factory.mktemp("spacenet"))
    make_spacenet_fixture(spacenet, image_size=160, spacing=40)
    cityscale = str(tmp_path_factory.mktemp("cityscale"))
    _chip_smoke().write_cityscale_fixture(cityscale, 256, spacing=48)
    return {"spacenet": spacenet, "cityscale": cityscale}


# ---------------------------------------------------------------- PNG


def _cv2_rgb(path):
    img = cv2.imread(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _filtered_rows(path):
    """The decompressed, still filtered rows of a PNG and its bytes per
    pixel."""
    with open(path, "rb") as f:
        chunks = list(png._chunks(f.read(), path))
    w, h, _, color = struct.unpack(">IIBB", dict(chunks)[b"IHDR"][:10])
    bpp = {0: 1, 2: 3, 6: 4}[color]
    raw = zlib.decompress(b"".join(body for kind, body in chunks if kind == b"IDAT"))
    return np.frombuffer(raw, np.uint8).reshape(h, 1 + w * bpp), bpp


def _check_against_cv2(path, plain=True):
    got = png.read_png(path)
    want = cv2.imread(path, cv2.IMREAD_GRAYSCALE) if got.ndim == 2 else _cv2_rgb(path)
    assert got.dtype == np.uint8 and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)
    np.testing.assert_array_equal(dataset.read_rgb_img(path), jdataset.read_rgb_img(path))
    if plain:
        rows, bpp = _filtered_rows(path)
        np.testing.assert_array_equal(png.unfilter(rows, bpp), png.unfilter_plain(rows, bpp))
    return got


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _write_filtered(path, img, kinds):
    """A PNG whose row y uses filter kinds[y % len(kinds)]."""
    bpp = 1 if img.ndim == 2 else img.shape[2]
    h, w = img.shape[:2]
    raw = img.reshape(h, -1).astype(np.int64)
    up = np.zeros_like(raw)
    up[1:] = raw[:-1]
    left = np.zeros_like(raw)
    left[:, bpp:] = raw[:, :-bpp]
    upleft = np.zeros_like(raw)
    upleft[1:, bpp:] = raw[:-1, :-bpp]
    preds = [np.zeros_like(raw), left, up, (left + up) // 2, _paeth(left, up, upleft)]
    kind = np.array([kinds[y % len(kinds)] for y in range(h)])
    filt = (raw - np.choose(kind[:, None], preds)) & 255
    rows = np.concatenate([kind[:, None], filt], axis=1).astype(np.uint8)
    color = {1: 0, 3: 2, 4: 6}[bpp]
    with open(path, "wb") as f:
        f.write(png.SIGNATURE + png.chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
                + png.chunk(b"IDAT", zlib.compress(rows.tobytes())) + png.chunk(b"IEND", b""))


def _image(r, channels, h=23, w=31):
    shape = (h, w) if channels == 1 else (h, w, channels)
    img = r.integers(0, 256, shape).astype(np.uint8)
    img[4:12, 3:20] = r.integers(0, 256)  # a flat patch: libpng then picks other filters
    return img


def test_read_png_equals_cv2_on_fixtures(roots):
    paths = sorted(glob.glob(os.path.join(roots["spacenet"], "**", "*.png"), recursive=True))
    paths += sorted(glob.glob(os.path.join(roots["cityscale"], "**", "*.png"), recursive=True))
    assert len(paths) == 12 + 24
    for i, path in enumerate(paths):
        _check_against_cv2(path, plain=i % 6 == 0)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_read_png_equals_cv2_on_cv2_written_images(tmp_path, channels):
    """cv2.imwrite at compression 0, 1, 6 and 9 (libpng's adaptive
    filters); RGBA loses its alpha as in cv2.imread."""
    r = np.random.default_rng(channels)
    for level in (0, 1, 6, 9):
        img = _image(r, channels)
        path = str(tmp_path / f"img{level}.png")
        cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
        got = _check_against_cv2(path)
        rgb = img if channels == 1 else img[..., 2::-1]  # cv2 wrote BGR(A)
        np.testing.assert_array_equal(got, rgb)


@pytest.mark.parametrize("kinds", [[0], [1], [2], [3], [4], [4, 3, 2, 1, 0]])
def test_read_png_undoes_each_filter_type(tmp_path, kinds):
    r = np.random.default_rng(len(kinds) * 10 + kinds[0])
    for channels in (1, 3, 4):
        img = _image(r, channels)
        path = str(tmp_path / f"f{channels}.png")
        _write_filtered(path, img, kinds)
        got = _check_against_cv2(path)
        np.testing.assert_array_equal(got, img if channels == 1 else img[..., :3])


def test_write_png_round_trips(tmp_path):
    r = np.random.default_rng(11)
    for channels in (1, 3, 4):
        img = _image(r, channels)
        path = str(tmp_path / "w.png")
        png.write_png(path, img)
        np.testing.assert_array_equal(png.read_png(path), img if channels == 1 else img[..., :3])
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(want, img if channels == 1 else
                                      cv2.cvtColor(img, cv2.COLOR_RGB2BGR if channels == 3
                                                   else cv2.COLOR_RGBA2BGRA))
    with pytest.raises(TypeError):
        png.write_png(path, np.zeros((4, 4), np.float32))


def test_read_png_refuses_what_it_does_not_decode(tmp_path):
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, np.full((4, 5), 1000, np.uint16))
    with pytest.raises(ValueError, match="bit depth 16"):
        png.read_png(path)
    for color, interlace in ((3, 0), (4, 0), (2, 1)):  # palette, gray + alpha, interlaced
        with open(path, "wb") as f:
            f.write(png.SIGNATURE + png.chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 8, color, 0, 0,
                                                                    interlace))
                    + png.chunk(b"IDAT", zlib.compress(bytes(80))) + png.chunk(b"IEND", b""))
        with pytest.raises(ValueError, match="reads only"):
            png.read_png(path)
    _write_filtered(path, np.zeros((3, 4), np.uint8), [0])
    data = bytearray(open(path, "rb").read())
    data[-20] ^= 1  # inside the IDAT chunk: its CRC fails
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(path)
    rows = np.zeros((2, 5), np.uint8)
    rows[1, 0] = 7
    with pytest.raises(ValueError, match="filter type 7"):
        png.unfilter(rows, 1)


# ---------------------------------------------------------------- config


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(CONFIG_DIR, "*.yaml"))),
                         ids=os.path.basename)
def test_load_config_equals_yaml_over_defaults(path):
    with open(path) as f:
        want = {**tconfig.DEFAULTS, **yaml.safe_load(f)}
    got = tconfig.load_config(path).to_dict()
    assert got == want
    assert {k: type(v) for k, v in got.items()} == {k: type(v) for k, v in want.items()}


def test_saved_config_reads_back_equal(tmp_path):
    cfg = tconfig.load_config(os.path.join(CONFIG_DIR, "toponet_vitb_512_cityscale.yaml"),
                              overrides=dict(BASE_LR=1e-8, GRAD_CLIP_NORM=2.5e20, NOTE="it's # x",
                                             TRACE_DIR=None))
    out = tconfig.create_output_dir_and_save_config("unused", cfg, specified_dir=str(tmp_path))
    saved = os.path.join(out, "config.yaml")
    assert tconfig.read_flat_yaml(saved) == cfg.to_dict()
    with open(saved) as f:
        assert yaml.safe_load(f) == cfg.to_dict()
    for bad in ("A:\n  B: 1\n", "A: [1, 2]\n", "A: yes\n", "A: 1e-3\n", "A: 010\n",
                "A: 'x' y\n", "A: 1\nA: 2\n", "A:1\n"):
        with open(saved, "w") as f:
            f.write(bad)
        with pytest.raises(ValueError):
            tconfig.read_flat_yaml(saved)
    with pytest.raises(ValueError):
        tconfig.write_flat_yaml(saved, {"A": [1]})


# ---------------------------------------------------------------- graph


def _graphs():
    size = 160
    grid = make_grid_graph_rc(size, 40)
    return [(grid, lambda v: np.stack([v[:, 1], size - v[:, 0]], axis=1)),
            (_crossing_graph(1), lambda v: v[:, ::-1]),
            (_crossing_graph(2), lambda v: v[:, ::-1])]


def _same_graph(a, b):
    assert a.n_vertices == b.n_vertices
    for key in ("edges", "points", "_adj", "_offsets"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key), err_msg=key)


@pytest.mark.parametrize("case", [0, 1, 2])
def test_graph_library_matches_jax(case):
    adj, transform = _graphs()[case]
    r = np.random.default_rng(case)
    nodes, edges = convert.convert_from_sat2graph_format(adj)
    jnodes, jedges = jconvert.convert_from_sat2graph_format(adj)
    np.testing.assert_array_equal(nodes, jnodes)
    assert edges == jedges
    assert convert.edge_list_to_adj_table(nodes, edges) == jconvert.edge_list_to_adj_table(
        jnodes, jedges)

    g, jg = structure.graph_from_adj_dict(adj, transform), jstructure.graph_from_adj_dict(
        adj, transform)
    _same_graph(g, jg)
    np.testing.assert_array_equal(g.degree(), jg.degree())
    sub, jsub = structure.subdivide_graph(g, 4), jstructure.subdivide_graph(jg, 4)
    _same_graph(sub, jsub)
    crossings = geometry.find_crossover_points(g)
    assert crossings == jgeometry.find_crossover_points(jg)
    assert (len(crossings) > 0) == (case > 0)
    for _ in range(5):
        start = int(r.integers(sub.n_vertices))
        stop = set(r.integers(sub.n_vertices, size=6).tolist())
        depth = int(r.integers(1, 20))
        assert structure.bfs_with_conditions(sub, start, stop, depth) == \
            jstructure.bfs_with_conditions(jsub, start, stop, depth)

    index = spatial.PointGridIndex(sub.points, cell_size=16.0)
    jindex = jspatial.PointGridIndex(jsub.points, cell_size=16.0)
    a, b = sub.points[sub.edges[:, 0]], sub.points[sub.edges[:, 1]]
    rects = np.concatenate([np.minimum(a, b) - 1, np.maximum(a, b) + 1], axis=1)
    rindex, jrindex = spatial.RectGridIndex(rects), jspatial.RectGridIndex(rects)
    for _ in range(10):
        x0, y0 = r.uniform(-20, 200, 2)
        box = (x0, y0, x0 + r.uniform(0, 80), y0 + r.uniform(0, 80))
        np.testing.assert_array_equal(index.query_box(box), jindex.query_box(box))
        np.testing.assert_array_equal(rindex.query_box(box), jrindex.query_box(box))

    p, p2, q, q2 = (r.uniform(0, 100, (50, 2)) for _ in range(4))
    for got, want in zip(geometry.segments_intersect(p, p2, q, q2),
                         jgeometry.segments_intersect(p, p2, q, q2)):
        np.testing.assert_array_equal(got, want)
    for seg in ((p[0], p2[0]), (p[1], p[1])):
        for got, want in zip(geometry.point_segment_distance(q, *seg),
                             jgeometry.point_segment_distance(q, *seg)):
            np.testing.assert_array_equal(got, want)


def _same_sample(got, want):
    assert list(got) == list(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), key


@pytest.mark.parametrize("case", [0, 1, 2])
def test_graph_label_generator_matches_jax(case):
    adj, transform = _graphs()[case]
    over = dict(CITYSCALE, PATCH_SIZE=96)
    gen = GraphLabelGenerator(tconfig.load_config(overrides=over), adj, transform)
    jgen = JGraphLabelGenerator(jload_config(overrides=over), adj, transform)
    assert gen.exclude_indices == jgen.exclude_indices
    np.testing.assert_array_equal(gen.sample_weights, jgen.sample_weights)
    for k in range(8):
        x0, y0 = (16 * k) % 96, (24 * k) % 72
        patch = ((x0, y0), (x0 + 96, y0 + 96))
        pts, samples = gen.sample_patch(patch, k % 4, np.random.default_rng(k))
        jpts, jsamples = jgen.sample_patch(patch, k % 4, np.random.default_rng(k))
        np.testing.assert_array_equal(pts, jpts)
        assert samples == jsamples


@pytest.mark.parametrize("name", ["spacenet", "cityscale"])
def test_dataset_samples_and_loader_batches_match_jax(roots, name):
    """Tiles, train samples (random patch, rotation, labels) and eval
    samples byte-equal to the JAX SatMapDataset's; eval batches (with the
    ragged last batch's sample_weight) and single-producer train batches
    equal the JAX BatchLoader's; num_batches equal for 1 and 2 processes."""
    over = SPACENET if name == "spacenet" else CITYSCALE
    cfg, jcfg = tconfig.load_config(overrides=over), jload_config(overrides=over)
    kw = dict(data_root=roots[name], dev_run=name == "cityscale")
    for is_train in (True, False):
        ds = dataset.SatMapDataset(cfg, is_train=is_train, **kw)
        jds = jdataset.SatMapDataset(jcfg, is_train=is_train, **kw)
        assert len(ds) == len(jds) and ds.tile_indices == jds.tile_indices
        for a, b in zip(ds.rgbs + ds.road_masks + ds.keypoint_masks,
                        jds.rgbs + jds.road_masks + jds.keypoint_masks):
            np.testing.assert_array_equal(a, b)
        if is_train:
            for seed in range(6):
                _same_sample(ds.sample(0, np.random.default_rng(seed)),
                             jds.sample(0, np.random.default_rng(seed)))
            loaders = [L(d, 2, seed=3, num_batches=3, num_workers=1, point_bucket=32)
                       for L, d in ((dataset.BatchLoader, ds), (jdataset.BatchLoader, jds))]
        else:
            assert ds.eval_patches == jds.eval_patches
            for idx in range(len(ds)):
                _same_sample(ds.sample(idx, np.random.default_rng(idx)),
                             jds.sample(idx, np.random.default_rng(idx)))
            batch = 3 if len(ds) % 3 else 5
            loaders = [L(d, batch, point_bucket=32)
                       for L, d in ((dataset.BatchLoader, ds), (jdataset.BatchLoader, jds))]
            for procs in (1, 2):
                for p in range(procs):
                    assert (dataset.BatchLoader(ds, batch, process_index=p, process_count=procs)
                            .num_batches == jdataset.BatchLoader(
                                jds, batch, process_index=p, process_count=procs).num_batches)
        got, want = (list(loader) for loader in loaders)
        assert len(got) == len(want) == loaders[1].num_batches
        for g, w in zip(got, want):
            _same_sample(g, w)
        if not is_train:
            assert got[-1]["sample_weight"][-1] == 0.0


def test_batch_loader_raises_a_producer_error(roots):
    ds = dataset.SatMapDataset(tconfig.load_config(overrides=SPACENET), is_train=True,
                               data_root=roots["spacenet"])
    broken = dataset.BatchLoader(ds, batch_size=2, num_batches=2, point_bucket=32)
    ds.sample_max = ds.sample_min - 1  # rng.integers(low, high <= low) raises
    with pytest.raises(ValueError):
        list(broken)
