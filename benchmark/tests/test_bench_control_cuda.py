"""Each cell's control comes out not correct: the reference put in the
program's place and computed in the precision below the configuration's
(fp8 below bf16, TF32 below fp32) breaks at least one of the cell's limits.
At full width and the cell's resolution, with 24-frame clips where the
cell's are longer.  Needs a card and no JAX:
`python -m pytest -m cuda benchmark/tests/test_bench_control_cuda.py`."""
import json
import os

import pytest

from benchmark.checks import control
from benchmark.harness import cells
from benchmark.tests.conftest import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(card, name):
    cell = cells.find_cell(ROOT, name)
    if cell.traffic["runner"] == "stream":
        cell.traffic["clip_frames"] = min(cell.traffic["clip_frames"], 24)
        values = control.stream_readings(cell, 2 ** 31 + 101, card)
    else:
        values = control.train_readings(cell, 2 ** 31 + 101, card)
    assert any(v > cell.limits[k] for k, v in values.items() if k in cell.limits), values
