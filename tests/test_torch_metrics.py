"""The port's metric suite (sam_road_tpu_torch/metrics/) against the JAX
package's (sam_road_tpu/metrics/) on the same inputs, made from a seed with
numpy.

- latlon and Hopcroft-Karp on random inputs and bigraphs: exact.
- Python APLS on identical, degraded, jittered and spacenet-sized grids:
  equal to JAX's exactly (the same arithmetic in the same order). The port's
  APLS executable writes the same text as JAX's, and agrees with the port's
  Python APLS within 1e-6 (it prints 6 decimals).
- TOPO's marble stream, bounded location distance, match count and tile
  score, native and Python: equal to JAX's and to each other, exactly.
- The runner's score files, svg, crop_prediction, convert_from_nx and
  inspect_graph: equal to JAX's.
- A native build that cannot happen raises, and nothing scores in Python
  unless asked; metrics/ imports neither torch nor jax.

The JAX natives build into the shared native/build/ with a non-atomic
`g++ -o`, so they are loaded with retries first (_load_jax_metrics_native):
a JAX loader that met a half-written file would stay on its Python path.
"""

import functools
import json
import os
import pickle
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from sam_road_tpu.graph import convert as jconvert
from sam_road_tpu.metrics import _native as jnative
from sam_road_tpu.metrics import apls as japls
from sam_road_tpu.metrics import apls_native as japls_native
from sam_road_tpu.metrics import latlon as jlatlon
from sam_road_tpu.metrics import matching as jmatching
from sam_road_tpu.metrics import runner as jrunner
from sam_road_tpu.metrics import spacenet_convert as jspacenet_convert
from sam_road_tpu.metrics import svg as jsvg
from sam_road_tpu.metrics import topo as jtopo
from sam_road_tpu.metrics.topo_graph import create_graph_from_adj as jcreate_graph
from sam_road_tpu_torch import _native as port_native
from sam_road_tpu_torch.graph import convert
from sam_road_tpu_torch.metrics import _native, apls, apls_native, latlon, matching, runner
from sam_road_tpu_torch.metrics import spacenet_convert, svg, topo
from sam_road_tpu_torch.metrics.topo_graph import create_graph_from_adj
from test_metrics import grid_adj
from test_topo_native import _grid_adj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_jax_metrics_native(attempts: int = 20, pause: float = 0.25):
    """Load the JAX package's TOPO library and APLS executable, retrying
    while a load fails (TOPO: clear the loader's tried flag) or the
    executable does not run (APLS: run it without arguments, which prints
    its usage and exits 1), then require both."""
    for _ in range(attempts):
        if jnative.load_topo_native() is not None:
            break
        jnative._NATIVE_TRIED = False
        time.sleep(pause)
    assert jnative.load_topo_native() is not None, "JAX native TOPO library"

    def runs():
        binary = japls_native.ensure_apls_binary()
        try:
            proc = subprocess.run([binary], capture_output=True, text=True, timeout=60)
        except (TypeError, OSError):
            return False
        return proc.returncode == 1 and "usage" in proc.stderr

    for _ in range(attempts):
        if runs():
            break
        time.sleep(pause)
    assert runs(), "JAX native APLS executable"


@pytest.fixture(autouse=True, scope="module")
def jax_native():
    _load_jax_metrics_native()


@pytest.fixture()
def python_topo():
    """Runs a callable with the port's and JAX's TOPO on their Python
    bodies."""
    def run(fn):
        jdll = jnative._NATIVE
        jnative._NATIVE = None
        _native.USE_NATIVE = False
        try:
            return fn()
        finally:
            jnative._NATIVE = jdll
            _native.USE_NATIVE = True

    return run


# ------------------------------------------------------------ latlon, matching

def _latlon_args(fn, r):
    p = lambda: (41.0 - r.uniform(0, 0.02), -71.0 + r.uniform(0, 0.03))  # noqa: E731
    return {"xy2latlon": lambda: tuple(r.uniform(-100, 2100, 2)),
            "distance": lambda: (p(), p()),
            "gps_distance": lambda: (p(), p()),
            "latlon_norm": lambda: (tuple(r.normal(size=2) * 1e-3),),
            "point_to_line_distance_latlon": lambda: (p(), p(), p())}[fn]()


@pytest.mark.parametrize("fn", ["xy2latlon", "distance", "gps_distance", "latlon_norm",
                                "point_to_line_distance_latlon"])
def test_latlon_matches_jax(fn):
    r = np.random.default_rng(len(fn))
    for _ in range(200):
        args = _latlon_args(fn, r)
        assert getattr(latlon, fn)(*args) == getattr(jlatlon, fn)(*args)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hopcroft_karp_matches_jax(seed):
    r = np.random.default_rng(seed)
    n_left, n_right = 40 + 30 * seed, 50
    si = r.integers(0, n_left, 3 * n_left)
    ti = r.integers(0, n_right, 3 * n_left)
    bigraph = {}
    for s, t in zip(si.tolist(), ti.tolist()):
        bigraph.setdefault(f"u{s}", set()).add(t)
    want = jmatching.maximum_matching_size(bigraph)
    assert matching.maximum_matching_size(bigraph) == want
    assert matching.maximum_matching_size_pairs(si, ti) == want
    assert jmatching.maximum_matching_size_pairs(si, ti) == want
    assert matching.maximum_matching_size_pairs([], []) == 0


# ------------------------------------------------------------------------ APLS

def _jittered(size, seed, jitter=1.0, drop=0.1):
    return _grid_adj(size=size, seed=seed, jitter=jitter, drop=drop)


APLS_CASES = {  # name -> (gt, proposal, spacenet)
    "identical": lambda: (_grid_adj(size=384), _grid_adj(size=384), False),
    "degraded": lambda: (grid_adj(size=768, spacing=160, lo=160, hi=640),
                         grid_adj(size=768, spacing=160, lo=160, hi=640, drop_edges={
                             ((320, 320), (320, 480)), ((480, 320), (480, 480))}), False),
    "jittered": lambda: (_grid_adj(size=384, seed=0), _jittered(384, 1), False),
    "spacenet": lambda: (grid_adj(size=352, spacing=60, lo=60, hi=300),
                         grid_adj(size=352, spacing=60, lo=60, hi=300,
                                  drop_edges={((120, 120), (120, 180))}), True),
}


@functools.cache
def _apls_case(name):
    """The case's APLS JSON graphs and both packages' Python scores."""
    gt, prop, spacenet = APLS_CASES[name]()
    g, p = apls.sat2graph_to_apls_json(gt), apls.sat2graph_to_apls_json(prop)
    assert (g, p) == (japls.sat2graph_to_apls_json(gt), japls.sat2graph_to_apls_json(prop))
    return g, p, spacenet, apls.apls_score(g, p, spacenet), japls.apls_score(g, p, spacenet)


@pytest.mark.parametrize("case", list(APLS_CASES))
def test_python_apls_matches_jax(case):
    *_, got, want = _apls_case(case)
    assert got == want
    assert 0 <= got[2] <= 1
    if case == "identical":
        assert got[2] > 0.97


@pytest.mark.parametrize("case", ["degraded", "jittered", "spacenet"])
def test_apls_executable_matches_jax_and_python(case, tmp_path):
    """The port's executable writes JAX's executable's text, and its
    scores are the port's Python scores to print precision."""
    g, p, spacenet, python, _ = _apls_case(case)
    gp, pp = str(tmp_path / "gt.json"), str(tmp_path / "prop.json")
    for path, graph in ((gp, g), (pp, p)):
        with open(path, "w") as f:
            json.dump(graph, f)
    got = apls_native.apls_score_files_native(gp, pp, str(tmp_path / "port.txt"), spacenet)
    want = japls_native.apls_score_files_native(gp, pp, str(tmp_path / "jax.txt"), spacenet)
    assert got == want
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    assert max(abs(a - b) for a, b in zip(got, python)) < 1e-6, (got, python)
    assert os.path.dirname(apls_native.ensure_apls_binary()) == port_native.BUILD_DIR


# ------------------------------------------------------------------------ TOPO

@pytest.mark.parametrize("bidirection", [False, True])
def test_topo_walk_stream_matches_jax(bidirection, python_topo):
    adj = _grid_adj()
    g, _ = create_graph_from_adj(adj)
    jg, _ = jcreate_graph(adj)
    assert g.edges == jg.edges and g.nodeLinkReverse == jg.nodeLinkReverse
    for a, b in sorted(g.edgeHash)[::7][:20]:
        l = latlon.distance(g.nodes[a], g.nodes[b])
        kw = dict(step=0.00005, r=0.0015, newstyle=True, nid1=a, nid2=b,
                  dist1=0.3 * l, dist2=0.7 * l, bidirection=bidirection)
        native = g.TOPOWalk(1, **kw)
        plain = np.asarray(python_topo(lambda: g.TOPOWalk(1, **kw)), np.float64).reshape(-1, 4)
        want = np.asarray(jg.TOPOWalk(1, **kw))
        assert len(want) > 0
        np.testing.assert_array_equal(native, want)
        np.testing.assert_array_equal(plain, want)


def test_topo_loc_distance_matches_jax(python_topo):
    adj = _grid_adj()
    g, _ = create_graph_from_adj(adj)
    jg, _ = jcreate_graph(adj)
    edges = sorted(g.edgeHash)
    for i in range(30):
        a, b = edges[(i * 11) % len(edges)]
        c, d = edges[(i * 29 + 5) % len(edges)]
        l1 = latlon.distance(g.nodes[a], g.nodes[b])
        l2 = latlon.distance(g.nodes[c], g.nodes[d])
        loc1, loc2 = (a, b, 0.4 * l1, 0.6 * l1), (c, d, 0.5 * l2, 0.5 * l2)
        want = jg.distanceBetweenTwoLocation(loc1, loc2, 0.0003)
        assert g.distanceBetweenTwoLocation(loc1, loc2, 0.0003) == want
        assert python_topo(lambda: g.distanceBetweenTwoLocation(loc1, loc2, 0.0003)) == want


@pytest.mark.parametrize("one2one", [False, True])
def test_topo_match_count_matches_jax(one2one, python_topo):
    r = np.random.default_rng(3)
    base = np.array([41.0, -71.0, 0.0, 0.0])
    scale = np.array([1e-4, 1e-4, 1e-3, 1e-3])
    src = [tuple(x) for x in r.normal(size=(400, 4)) * scale + base]
    tgt = [tuple(x) for x in r.normal(size=(500, 4)) * scale + base]
    want = jtopo._match_count(src, tgt, 0.00015, one2one)
    assert want > 0
    assert topo._match_count(src, tgt, 0.00015, one2one) == want
    assert python_topo(lambda: topo._match_count(src, tgt, 0.00015, one2one)) == want
    assert python_topo(lambda: jtopo._match_count(src, tgt, 0.00015, one2one)) == want


TOPO_CASES = {
    "identical": lambda: (_grid_adj(size=384), _grid_adj(size=384), False),
    "jittered": lambda: (_grid_adj(size=512, seed=0), _jittered(512, 1), False),
    "spacenet": APLS_CASES["spacenet"],
}


@pytest.mark.parametrize("case", list(TOPO_CASES))
def test_topo_score_one_tile_matches_jax(case, python_topo, tmp_path):
    """Native and Python, with the per-pair text file."""
    gt, prop, spacenet = TOPO_CASES[case]()
    want = jtopo.topo_score_one_tile(gt, prop, spacenet, outputfile=str(tmp_path / "jax.txt"))
    got = topo.topo_score_one_tile(gt, prop, spacenet, outputfile=str(tmp_path / "port.txt"))
    plain = python_topo(lambda: topo.topo_score_one_tile(
        gt, prop, spacenet, outputfile=str(tmp_path / "plain.txt")))
    assert got == plain == want
    text = (tmp_path / "jax.txt").read_text()
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "plain.txt").read_text() == text
    assert 0 <= got[2] <= 1
    if case == "identical":
        assert min(got) > 0.98


# ---------------------------------------------------------------------- runner

def _run_dir(root, name, graphs):
    run = os.path.join(root, name)
    os.makedirs(os.path.join(run, "graph"))
    for tile, adj in graphs.items():
        with open(os.path.join(run, "graph", f"{tile}.p"), "wb") as f:
            pickle.dump(adj, f)
    return run


def _score_files(run):
    """Every file the runner wrote, by path relative to the run dir."""
    out = {}
    for sub in ("results", "score"):
        for dirpath, _, names in os.walk(os.path.join(run, sub)):
            for name in names:
                path = os.path.join(dirpath, name)
                with open(path) as f:
                    out[os.path.relpath(path, run)] = f.read()
    return out


@pytest.mark.parametrize("metric", ["apls_native", "apls_python", "topo"])
def test_runner_matches_jax(metric, tmp_path):
    """Two Cityscale test tiles (a third, without a prediction, is left
    out by both runners): the same results/ and score/ files."""
    gt_dir = tmp_path / "data" / "cityscale" / "20cities"
    gt_dir.mkdir(parents=True)
    tiles = [8, 9, 19]
    preds = {}
    for n, tile in enumerate(tiles):
        with open(gt_dir / f"region_{tile}_graph_gt.pickle", "wb") as f:
            pickle.dump(_grid_adj(size=384, seed=n), f)
        preds[tile] = _jittered(384, 10 + n)
    del preds[19]
    runs = {}
    for name, module in (("port", runner), ("jax", jrunner)):
        run = _run_dir(str(tmp_path), name, preds)
        kw = dict(dataset="cityscale", data_root=str(tmp_path / "data"), tiles=tiles)
        if metric == "topo":
            module.evaluate_topo(run, **kw)
        else:
            module.evaluate_apls(run, use_native=metric == "apls_native", **kw)
        runs[name] = _score_files(run)
    assert runs["port"] == runs["jax"]
    score = json.loads(runs["port"]["score/topo.json" if metric == "topo" else "score/apls.json"])
    assert len(score["f1" if metric == "topo" else "apls"]) == 2


def test_runner_carries_the_topo_switch_to_its_workers(tmp_path, python_topo, monkeypatch):
    """Spawned workers start from a fresh import, so each job carries
    the caller's USE_NATIVE to the worker."""
    gt_dir = tmp_path / "data" / "cityscale" / "20cities"
    gt_dir.mkdir(parents=True)
    with open(gt_dir / "region_8_graph_gt.pickle", "wb") as f:
        pickle.dump(_grid_adj(size=384), f)
    run = _run_dir(str(tmp_path), "run", {8: _jittered(384, 1)})
    jobs = []
    monkeypatch.setattr(runner, "_pool", lambda workers: _Recorder(jobs))
    python_topo(lambda: runner.evaluate_topo(run, "cityscale", str(tmp_path / "data")))
    assert [job[-1] for job in jobs] == [False]
    runner.evaluate_topo(run, "cityscale", str(tmp_path / "data"))
    assert [job[-1] for job in jobs] == [False, True]


class _Recorder:
    """A stand-in pool that runs jobs in process and records them."""

    def __init__(self, jobs):
        self.jobs = jobs

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def map(self, fn, jobs):
        jobs = list(jobs)
        self.jobs.extend(jobs)
        use_native = _native.USE_NATIVE
        try:
            return [fn(job) for job in jobs]
        finally:
            _native.USE_NATIVE = use_native


# ------------------------------------------------------------ svg, crop, graph

def test_svg_matches_jax(tmp_path):
    """tests/test_aux.py's case, plus random marbles and holes."""
    r = np.random.default_rng(5)
    region = (0.0, 0.0, 1.0, 1.0)
    pts = [(0.5, 0.5), (0.2, 0.8)] + [tuple(p) for p in r.uniform(0, 1, (20, 2))]
    edges = [(0.1, 0.1, 0.9, 0.9)] + [tuple(e) for e in r.uniform(0, 1, (20, 4))]
    marbles = [tuple(m) for m in r.uniform(0, 1, (30, 4))]
    holes = [tuple(h) for h in r.uniform(0, 1, (30, 4))]
    for name, module in (("port", svg), ("jax", jsvg)):
        module.render_region(pts, edges, region, str(tmp_path / f"{name}_region.svg"))
        module.render_marbles_and_holes(marbles, holes, region, str(tmp_path / f"{name}_mh.svg"))
    for kind in ("region", "mh"):
        text = (tmp_path / f"port_{kind}.svg").read_text()
        assert "<svg" in text and "circle" in text
        assert text == (tmp_path / f"jax_{kind}.svg").read_text()


def test_crop_prediction_matches_jax(tmp_path):
    g = {(10, 10): [(200, 200)], (200, 200): [(10, 10), (210, 210)],
         (210, 210): [(200, 200)]}
    out = spacenet_convert.crop_prediction(g, margin=24, image_size=400)
    assert out == jspacenet_convert.crop_prediction(g, margin=24, image_size=400)
    assert (10, 10) not in out and (200, 200) in out
    jittered = _jittered(400, 3)
    src = tmp_path / "in"
    src.mkdir()
    for name, graph in (("a.p", g), ("b.p", jittered)):
        with open(src / name, "wb") as f:
            pickle.dump(graph, f)
    (src / "skip.txt").write_text("not a graph")
    spacenet_convert.crop_prediction_dir(str(src), str(tmp_path / "port"), margin=30)
    jspacenet_convert.crop_prediction_dir(str(src), str(tmp_path / "jax"), margin=30)
    assert sorted(os.listdir(tmp_path / "port")) == ["a.p", "b.p"]
    for name in ("a.p", "b.p"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


class _NxLike:
    """The two methods convert_from_nx reads, as a networkx Graph gives
    them (nodes in insertion order, each undirected edge once)."""

    def __init__(self, edges):
        self._edges = edges
        self._nodes = list(dict.fromkeys(n for e in edges for n in e))

    def nodes(self):
        return self._nodes

    def edges(self):
        return self._edges


@pytest.mark.parametrize("edges", [[((1, 2), (3, 4)), ((3, 4), (5, 6))], "random"])
def test_convert_from_nx_matches_jax(edges):
    if edges == "random":
        pts = [tuple(p) for p in np.random.default_rng(6).integers(0, 50, (30, 2)).tolist()]
        edges = list(dict.fromkeys(zip(pts[:-1], pts[1:])))
    graph = _NxLike(edges)
    got, want = convert.convert_from_nx(graph), jconvert.convert_from_nx(graph)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    if len(edges) == 2:  # tests/test_graph_lib.py's case
        np.testing.assert_array_equal(got[0], [[2, 1], [4, 3], [6, 5]])
        np.testing.assert_array_equal(got[1], [[0, 1], [1, 2]])


def test_inspect_graph_matches_jax(capsys):
    r = np.random.default_rng(7)
    nodes = np.concatenate([r.uniform(0, 100, (40, 2)), np.zeros((3, 2))])
    edges = r.integers(0, 43, (60, 2))
    got = convert.inspect_graph(nodes, edges)
    got_out = capsys.readouterr().out
    want = jconvert.inspect_graph(nodes, edges)
    assert got == want and got[1] >= 3
    assert got_out == capsys.readouterr().out


# ------------------------------------------------------------- no fallback

@pytest.mark.parametrize("what", ["apls_without_gxx", "topo_without_gxx", "compile_error"])
def test_a_native_build_that_cannot_happen_raises(what, tmp_path, monkeypatch):
    """No g++, or a source that does not compile: RuntimeError, and no
    score from the Python bodies."""
    gt = _grid_adj(size=384)
    if what == "compile_error":
        bad = tmp_path / "bad.cc"
        bad.write_text("int main() { return undeclared; }\n")
        with pytest.raises(RuntimeError, match="undeclared"):
            port_native.build_executable("bad", "g++", ["-O2"], [str(bad)])
        return
    monkeypatch.setattr(shutil, "which", lambda name, *a, **k: None)
    if what == "topo_without_gxx":
        _native._lib.cache_clear()
        try:
            with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
                topo.topo_score_one_tile(gt, gt)
        finally:
            _native._lib.cache_clear()
        return
    gt_dir = tmp_path / "cityscale" / "20cities"
    gt_dir.mkdir(parents=True)
    with open(gt_dir / "region_8_graph_gt.pickle", "wb") as f:
        pickle.dump(gt, f)
    run = _run_dir(str(tmp_path), "run", {8: gt})
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        runner._apls_one_tile((8, str(gt_dir / "region_8_graph_gt.pickle"),
                               os.path.join(run, "graph", "8.p"),
                               str(tmp_path), True, False))
    assert not os.path.exists(tmp_path / "8.txt")


def test_metrics_import_neither_torch_nor_jax():
    """Every module of metrics/ and the evaluation CLI, in a fresh
    interpreter."""
    names = sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "sam_road_tpu_torch", "metrics"))
                   if f.endswith(".py") and f != "__init__.py")
    assert len(names) == 10
    code = ("import sys\nimport sam_road_tpu_torch.metrics\n"
            + "".join(f"import sam_road_tpu_torch.metrics.{n}\n" for n in names)
            + "import sam_road_tpu_torch.cli.evaluate\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'sam_road_tpu', 'yaml', 'cv2', 'networkx'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120, check=True)
    assert out.stdout.strip() == "[]"
