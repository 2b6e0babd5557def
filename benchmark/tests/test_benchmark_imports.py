"""What the benchmark loads, by whole top-level module name (the part
before the first dot: sam_road_tpu_torch begins with sam_road_tpu and is
another package). Each check runs in a fresh interpreter, since pytest's
own process has loaded the JAX package for the repository's other tests."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from bench_tiny import REPO

TESTS = os.path.dirname(os.path.abspath(__file__))


def loaded_after(code: str) -> set:
    """Top-level names of the modules loaded once `code` has run."""
    script = (f"import sys; sys.path[:0] = [{REPO!r}, {TESTS!r}]\n{code}\n"
              "import json; print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600, cwd=REPO, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-4000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_no_jax(tmp_path):
    code = f"""
import glob, torch
from bench_tiny import make_tiny
from benchmark import run, control
for path in glob.glob({os.path.join(REPO, 'benchmark', 'metrics', '*.py')!r}):
    run.reader(os.path.basename(path)[:-3])
import os
spec, root = make_tiny(__import__('pathlib').Path({str(tmp_path)!r}))
for cell in ("region.vitb_512", "train.vith_256"):
    for trace in (False, True):
        run.execute(spec, cell, 5, 0.2, trace, torch.device("cpu"), root=root)
"""
    found = loaded_after("import os" + code)
    assert "sam_road_tpu_torch" in found
    assert not found & {"jax", "jaxlib", "flax", "sam_road_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    found = loaded_after("from benchmark.reference import encoders, model, region, train\n"
                         "from benchmark import correct, counts, traffic\n"
                         "encoders.family({})")
    assert not found & {"sam_road_tpu_torch", "sam_road_tpu", "jax", "jaxlib", "flax"}


def test_nothing_reads_the_jax_side():
    """No benchmark source names the JAX package's bench, its tools or
    its recorded results."""
    for folder, _, files in os.walk(os.path.join(REPO, "benchmark")):
        for name in files:
            if not name.endswith(".py") or name == os.path.basename(__file__):
                continue
            with open(os.path.join(folder, name)) as f:
                text = f.read()
            for word in ("import jax", "from jax", "BENCH_r", "bench.py\"", "from tools",
                         "import tools", "sam_road_tpu.", "from sam_road_tpu import"):
                assert word not in text, (name, word)
