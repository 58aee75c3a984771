"""The harness's own rules: no result line without the cards a cell asks
for, the result line's keys with the compared numbers last, and
BENCHMARK.json within the shapes its readers accept."""
import json
import math
import os
import re
import subprocess
import sys

import pytest

from benchmark.harness import cells
from benchmark.harness.main import result_line
from benchmark.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_no_result_without_a_card(tmp_path):
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "s4-train-320-fp32-4chip", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "s4-train-320-fp32-4chip", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_result_line_keys():
    cell = cells.find_cell(ROOT, "s4-train-320-fp32-4chip")
    out = {"end_to_end": {"setup_s": 30.5, "train_step_ms": 210.25}, "correct": True,
           "attempted": 40, "failed": 0, "kind": "NVIDIA H100 80GB HBM3",
           "memory_peak_bytes": 12e9,
           "compared": {"loss_rel": (1e-4, 1e-3), "grad_gap": (math.nan, 0.5)}}
    line = result_line(cell, out, trace=False)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert line["metrics"] == {"setup_s": {"value": 30.5, "unit": "s"},
                               "train_step_ms": {"value": 210.25, "unit": "ms"}}
    assert line["compared"]["grad_gap"] == {"value": None, "limit": 0.5}
    json.loads(json.dumps(line))


def test_benchmark_json_shapes():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    configs = {c["name"] for c in b["configs"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    fours = 0
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["config"] in configs
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        fours += w["chips"] == 4
        cell = cells.find_cell(ROOT, w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        assert all(m["moves"] in reported for m in cell.per_layer)
        assert cell.limits, w["name"]
    assert fours <= max(1, len(b["workloads"]) // 4)
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))
