"""One short run of each cell on a card, as the command runs it. Skips
where no CUDA card is present (decided inside the test)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from bench_tiny import REPO, read


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in read("BENCHMARK.json")["workloads"]])
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell,
                          "--seed", str(2 ** 31 + 5), "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, cwd=REPO, timeout=1200,
                         env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
