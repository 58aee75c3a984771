"""The stream runner's window on the CPU at model scale 4: over several
clips it judges the window's last clip, and no clip's outputs are still
held when the next clip is served."""
import gc
import time
import types
import weakref

from benchmark.runners import stream
from benchmark.tests.conftest import shrink
from benchmark.tests.test_bench_faults import LIMITS

CELL = "s4-stream-1088x1920-bf16"
CLIP_S = 0.4        # each clip's time on the fake clock that ends the window


def test_window_judges_its_last_clip_and_holds_no_earlier_one(tmp_path, monkeypatch, eager_bank):
    cell = shrink(tmp_path, CELL, limits=LIMITS[CELL], chips=1)
    cell.traffic["dtype"] = "fp32"
    served, alive_at_serve, judged = [], [], []
    serve, judge = stream._serve, stream.judge

    def watched(ev, joint, frames, tri):
        gc.collect()
        alive_at_serve.append(sum(r() is not None for _, refs in served for r in refs))
        alphas, trimaps = serve(ev, joint, frames, tri)
        served.append((frames, [weakref.ref(a) for a in alphas + trimaps]))
        return alphas, trimaps

    def seen(cell, seed, last, *a):
        judged.append(last)
        return judge(cell, seed, last, *a)

    ticks = iter(range(10 ** 6))
    monkeypatch.setattr(stream, "time", types.SimpleNamespace(
        perf_counter=lambda: CLIP_S / 2 * next(ticks)))
    monkeypatch.setattr(stream, "_serve", watched)
    monkeypatch.setattr(stream, "judge", seen)
    out = stream.run(cell, seed=2 ** 31 + 29, seconds=4 * CLIP_S, trace=False,
                     t_start=time.time(), device="cpu")
    n, window = cell.traffic["clip_frames"], len(served) - 1            # the warm-up first
    assert out["correct"], out["compared"]
    assert window >= 3 and out["attempted"] == n * window
    assert alive_at_serve == [0] * len(served)
    (frames, _, got), = judged
    assert frames is served[-1][0]
    outputs = {id(r()) for r in served[-1][1] if r() is not None}
    assert got and all(id(x) in outputs for pair in got.values() for x in pair)
