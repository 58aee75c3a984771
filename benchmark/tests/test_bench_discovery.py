"""A configuration, a cell and a per-layer metric added as new files and
entries in a copy of the benchmark are found by name, with no existing
file edited."""
import json
import os
import shutil

from benchmark.harness import cells
from benchmark.tests.conftest import ROOT


def _snapshot(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.join(d, f)] = fh.read()
    return out


def test_new_files_are_found_by_name(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _snapshot(root)
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "otvm-s4.json")) as f:
        config = json.load(f)
    config.update(name="otvm-s4-bn", fba_arch="resnet50_BN")
    with open(os.path.join(b, "configs", "otvm-s4-bn.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(b, "traffic", "stream-512x512-bf16.json"), "w") as f:
        json.dump({"runner": "stream", "dtype": "bf16", "height": 512, "width": 512,
                   "clip_frames": 30, "distinct_frames": 4, "distinct_trimaps": 1,
                   "judged_frames": 6}, f)
    with open(os.path.join(b, "limits", "s4-stream-512-bf16-bn.json"), "w") as f:
        json.dump({"replay_slot_rel": 0.1}, f)
    with open(os.path.join(b, "metrics", "frames_in_slice.stream.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx['window_s'] * 2\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "otvm-s4-bn", "source": "https://github.com/Hongje/OTVM",
                             "file": "benchmark/configs/otvm-s4-bn.json", "reduced": [],
                             "why": "the BN trunk"})
    bench["workloads"].append({"name": "s4-stream-512-bf16-bn", "config": "otvm-s4-bn",
                               "traffic": "stream-512x512-bf16", "chips": 1, "why": "GN bypassed"})
    bench["per_layer"].append({"name": "frames_in_slice.stream", "unit": "s", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "stream_fps", "workloads": ["s4-stream-512-bf16-bn"]})
    for m in bench["end_to_end"]:
        if m["name"] == "stream_fps":
            m["workloads"].append("s4-stream-512-bf16-bn")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    cell = cells.find_cell(root, "s4-stream-512-bf16-bn")
    assert cell.config["fba_arch"] == "resnet50_BN" and cell.traffic["height"] == 512
    assert cell.limits == {"replay_slot_rel": 0.1}
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "stream_fps"]
    assert cells.runner(cell).__name__ == "benchmark.runners.stream"
    assert "frames_in_slice.stream" in [m["name"] for m in cell.per_layer]
    values = cells.per_layer_values(cell, {"window_s": 1.5, "busy_s": 1.2, "kernel_s": {},
                                           "flops": 3e12, "peak_flops": 989e12,
                                           "read_least_s": 0.0, "counters": {}})
    assert values["frames_in_slice.stream"] == {"value": 3.0, "unit": "s"}
    # a reader that finds nothing leaves its metric out
    assert "memory_read_roofline.stream" not in values and "capture_s.stream" not in values
    after = _snapshot(root)
    assert all(after[p] == before[p] for p in before)            # nothing edited
