"""Shared by the benchmark's tests: the repository's root on the path, and
a cell of BENCHMARK.json shrunk to the CPU (the configuration at model
scale 4, the traffic at tiny sizes) in a temporary tree."""
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL_STREAM = {"height": 64, "width": 96, "clip_frames": 24, "distinct_frames": 3,
                "distinct_trimaps": 2, "judged_frames": 4}
SMALL_TRAIN = {"batch": 2, "frames": 3, "height": 64, "width": 64, "distinct_batches": 7}


def shrink(tmp, cell: str, limits=None, chips=None):
    """A copy of the repository's benchmark tree under tmp with cell's
    configuration at model scale 4 and its traffic small; returns the
    harness's Cell for it."""
    from benchmark.harness import cells

    root = str(tmp)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    work = next(w for w in bench["workloads"] if w["name"] == cell)
    if chips is not None:
        work["chips"] = chips
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    path = os.path.join(root, conf["file"])
    with open(path) as f:
        config = json.load(f)
    config["model_scale"] = 4
    with open(path, "w") as f:
        json.dump(config, f)
    tpath = os.path.join(root, "benchmark", "traffic", work["traffic"] + ".json")
    with open(tpath) as f:
        traffic = json.load(f)
    traffic.update(SMALL_STREAM if traffic["runner"] == "stream" else SMALL_TRAIN)
    with open(tpath, "w") as f:
        json.dump(traffic, f)
    if limits is not None:
        with open(os.path.join(root, "benchmark", "limits", cell + ".json"), "w") as f:
            json.dump(limits, f)
    return cells.find_cell(root, cell)


@pytest.fixture
def card():
    """Skips without a CUDA card; the card's device otherwise."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def eager_bank(monkeypatch):
    """On the CPU the evaluator serves eagerly and keeps no static bank:
    the bank it makes for a clip is recorded, and the runner reads the last
    one as it reads the graphs' static bank on a card."""
    from otvm_tpu_torch.eval import runner

    from benchmark.runners import stream

    made = []
    make = runner.make_eval_bank

    def recording(*a, **k):
        made.append(make(*a, **k))
        return made[-1]

    monkeypatch.setattr(runner, "make_eval_bank", recording)
    monkeypatch.setattr(stream, "_final_bank", lambda ev, h, w, count, dtype: (
        made[-1].keys[:, :count].clone(), made[-1].values[:, :count].clone()))
