"""BENCHMARK.json against the benchmark's contract: names, units, the files
each entry names, and the per-layer metrics' readers."""

from __future__ import annotations

import os
import re

import pytest

from bench_tiny import REPO, read

SPEC = read("BENCHMARK.json")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert not any(w.startswith("/") or ".." in w for w in SPEC["command"])


@pytest.mark.parametrize("name", [m["name"] for m in METRICS]
                         + [c["name"] for c in SPEC["configs"]]
                         + [w["name"] for w in SPEC["workloads"]]
                         + [w["traffic"] for w in SPEC["workloads"]])
def test_names(name):
    assert NAME.fullmatch(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.fullmatch(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


def test_unique_names():
    for group in (METRICS, SPEC["configs"], SPEC["workloads"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_end_to_end():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert os.path.exists(os.path.join(REPO, "benchmark", "metrics", metric["name"] + ".py"))
    moves = next(m for m in SPEC["end_to_end"] if m["name"] == metric["moves"])
    assert set(metric["workloads"]) <= set(moves.get("workloads", metric["workloads"]))


@pytest.mark.parametrize("work", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_files(work):
    assert work["chips"] in (1, 4) and 1 <= len(work["why"]) <= 200
    config = next(c for c in SPEC["configs"] if c["name"] == work["config"])
    cfg = read(config["file"])
    assert cfg["reduced"] == config["reduced"] == []
    assert read(f"benchmark/traffic/{work['traffic']}.json")["kind"] in ("region", "train")
    limits = read(f"benchmark/limits/{work['name']}.json")
    assert all(v["limit"] >= 0 for v in limits.values())


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in SPEC["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] for m in SPEC["per_layer"])
