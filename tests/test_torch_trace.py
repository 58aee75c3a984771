"""The port's spans and counters (otvm_tpu_torch/utils/trace.py) on the
CPU: off they record nothing and never call record_function; under
torch.profiler they are nested otvm.* ranges on the profiler's clock; the
serving loops, the eager train step and the Loader's wait record them
where the work happens; the benchmark's readers of them (benchmark/
metrics/host_frame_ms.stream.py, host_step_ms.train.py) on synthetic
records.  Scale-4 models at 64x64, one torch thread."""
import importlib.util
import os
import time

import numpy as np
import pytest
import torch

from otvm_tpu_torch.utils import trace
from tests.torch_port import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE, HW, N = 4, 64, 4
FRAME_CHILDREN = {"serve.prepare", "serve.upload", "serve.step", "serve.readback_wait",
                  "serve.outputs", "serve.prefetch"}


@pytest.fixture(autouse=True)
def clean():
    """Each test starts and ends with tracing off and no records."""
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _raise(*args, **kwargs):
    raise AssertionError("record_function called on the off path")


def test_off_records_nothing_and_never_calls_record_function(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    assert not trace.enabled()
    with trace.span("serve.frame", clip=0, frame=0):
        with trace.span("serve.step"):
            trace.count("serve.frames")
    assert trace.span("a") is trace.span("b")           # the shared no-op
    assert trace.records() == [] and trace.totals() == {} and trace.dropped() == 0


def test_enabled_spans_nest_count_and_total(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)   # no profiler: no range
    trace.enable()
    with trace.span("train.step", step=3, rank=0):
        with trace.span("train.upload"):
            time.sleep(0.002)
        with trace.span("train.replay"):
            pass
    trace.count("train.steps")
    trace.count("train.steps", 2)
    up, replay, step, c1, c2 = trace.records()
    assert (up.name, replay.name, step.name) == ("train.upload", "train.replay", "train.step")
    assert up.parent == replay.parent == step.id and step.parent == 0
    assert step.ids == {"step": 3, "rank": 0} and up.ids == {}
    assert step.start_ns <= up.start_ns <= up.end_ns <= replay.start_ns <= step.end_ns
    assert up.ms >= 2.0 and step.ms >= up.ms
    assert (c1.kind, c1.n, c2.n, c1.parent) == ("count", 1, 2, 0)
    tot = trace.totals()
    assert tot["train.steps"] == {"n": 3} and tot["train.step"]["n"] == 1
    assert tot["train.upload"]["ms"] == pytest.approx(up.ms)
    trace.disable()
    with trace.span("train.step"):
        pass
    assert len(trace.records()) == 5


def test_take_absorb_and_the_cap(monkeypatch):
    trace.enable()
    with trace.span("serve.frame"):
        pass
    mine = trace.take()
    assert trace.records() == [] and mine[0].rank is None
    trace.absorb(1, mine)
    trace.absorb(2, mine)
    assert [r.rank for r in trace.records()] == [1, 2]
    monkeypatch.setattr(trace, "MAX_RECORDS", 3)
    for _ in range(4):
        trace.count("serve.frames")
    assert len(trace.records()) == 3 and trace.dropped() == 3
    trace.reset()
    assert trace.records() == [] and trace.dropped() == 0


def test_spans_under_the_profiler_are_nested_ranges_on_its_clock():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with trace.span("serve.frame", clip=0, frame=i):
                with trace.span("serve.step"):
                    torch.ones(8).sum()
                    time.sleep(0.003)
    assert not trace.enabled()
    recs = trace.records()
    assert [r.name for r in recs] == ["serve.step", "serve.frame"] * 3
    origin = prof.profiler.kineto_results.trace_start_ns()
    events = {name: [e for e in prof.events() if e.name == "otvm." + name]
              for name in ("serve.frame", "serve.step")}
    assert len(events["serve.frame"]) == len(events["serve.step"]) == 3
    for name, evs in events.items():
        mine = [r for r in recs if r.name == name]
        for r, e in zip(mine, sorted(evs, key=lambda e: e.time_range.start)):
            assert abs(origin + 1e3 * e.time_range.start - r.start_ns) < 1e6, name
            assert abs(origin + 1e3 * e.time_range.end - r.end_ns) < 1e6, name
    for outer, inner in zip(events["serve.frame"], events["serve.step"]):
        assert outer.time_range.start <= inner.time_range.start
        assert inner.time_range.end <= outer.time_range.end
        assert any(c.name == "aten::sum" for c in inner.cpu_children)
    # off again once the profiler has stopped
    with trace.span("serve.frame"):
        pass
    assert len(trace.records()) == 6


def test_profile_trace_exports_the_spans(tmp_path):
    from otvm_tpu_torch.utils.logging import profile_trace

    with profile_trace(str(tmp_path), enabled=True):
        with trace.span("data.wait"):
            torch.ones(4).sum()
    assert '"otvm.data.wait"' in (tmp_path / "trace.json").read_text()


def _clip(n=N, seed=0):
    rng = np.random.RandomState(seed)
    frames = [rng.rand(HW, HW, 3).astype(np.float32) for _ in range(n)]
    tri = np.zeros((HW, HW, 3), np.float32)
    tri[..., 0] = 1
    tri[16:48, 16:48] = (0, 1, 0)
    tri[24:40, 24:40] = (0, 0, 1)
    return frames, tri


def _frames_with_children(recs, n):
    frames = [r for r in recs if r.name == "serve.frame"]
    assert [r.ids["frame"] for r in frames] == list(range(n))
    assert len({r.ids["clip"] for r in frames}) == 1
    for i, f in enumerate(frames):
        kids = [r for r in recs if r.parent == f.id]
        names = {r.name for r in kids}
        # the first frame has no earlier frame to read back, the last reads its own
        want = FRAME_CHILDREN if 0 < i or n == 1 else FRAME_CHILDREN - {"serve.readback_wait",
                                                                        "serve.outputs"}
        assert names == want, (i, names)
        assert all(f.start_ns <= k.start_ns <= k.end_ns <= f.end_ns for k in kids)
    assert trace.totals(recs)["serve.frames"]["n"] == n
    return frames


def test_streaming_run_video_records_each_frame():
    from otvm_tpu_torch.eval.runner import EvalProtocol, StreamingEvaluator
    from otvm_tpu_torch.models.otvm import init_models

    stm, fba = init_models(seed=0, stage=4, scale=SCALE)
    ev = StreamingEvaluator(stm.state_dict(), fba.state_dict(),
                            EvalProtocol(scale=SCALE), device="cpu")
    frames, tri = _clip()
    trace.enable()
    alphas, _, _ = ev.run_video(frames, tri)
    recs = trace.records()
    assert len(alphas) == N
    _frames_with_children(recs, N)
    steps = [r for r in recs if r.name == "serve.step"]
    assert len(steps) == N and all(r.ms > 0 for r in steps)
    # the last frame reads its own outputs: nothing runs outside the frames
    frame_ids = {r.id for r in recs if r.name == "serve.frame"}
    assert all(r.parent in frame_ids for r in recs if r.name in FRAME_CHILDREN)


def test_trimap_run_video_records_each_frame():
    from otvm_tpu_torch.eval.runner import EvalProtocol, TrimapEvaluator
    from otvm_tpu_torch.models.stm import STM

    torch.manual_seed(0)
    ev = TrimapEvaluator(STM(hdim=-1, scale=SCALE, norm="gn").state_dict(),
                         EvalProtocol(scale=SCALE), device="cpu")
    frames, tri = _clip(3, seed=1)
    trace.enable()
    trimaps, _ = ev.run_video(frames, tri)
    assert len(trimaps) == 3
    _frames_with_children(trace.records(), 3)


def test_eager_train_step_records_the_step_and_its_upload():
    from otvm_tpu_torch import config
    from otvm_tpu_torch.data.loader import encode_wire
    from otvm_tpu_torch.train import trainer as T

    cfg = config.get_cfg_defaults()
    cfg.train.stage, cfg.model_scale = 1, SCALE
    state = T.init_train_state(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    batch = encode_wire(dict(fg=rng.rand(1, 2, HW, HW, 3), bg=rng.rand(1, 2, HW, HW, 3),
                             alpha=rng.rand(1, 2, HW, HW, 1),
                             tri=np.eye(3)[rng.randint(0, 3, (1, 2, HW, HW))]))
    step = T.make_train_step(cfg)
    trace.enable()
    for _ in range(2):
        state, _ = step(state, batch)
    recs = trace.records()
    steps = [r for r in recs if r.name == "train.step"]
    assert [r.ids for r in steps] == [{"step": 0, "rank": 0}, {"step": 1, "rank": 0}]
    for s in steps:
        kids = [r for r in recs if r.parent == s.id]
        assert [r.name for r in kids] == ["train.upload", "train.device_step"]
        assert all(s.start_ns <= k.start_ns <= k.end_ns <= s.end_ns for k in kids)
    assert trace.totals()["train.steps"] == {"n": 2}


def test_timed_batches_records_the_loader_wait():
    from otvm_tpu_torch.cli.train import timed_batches

    waits = []
    trace.enable()
    batches = [{"x": 1}, {"x": 2}]
    assert list(timed_batches((b for b in batches), waits)) == batches
    # the wait that ends the iteration is a span too, and no entry of `waits`
    assert len(waits) == 2 and trace.totals()["data.wait"]["n"] == 3


def _reader(name):
    path = os.path.join(ROOT, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(name, start_ms, end_ms, id_, parent=0):
    return trace.Record(name, "span", int(start_ms * 1e6), int(end_ms * 1e6), id_, parent, {})


def _count(name, n):
    return trace.Record(name, "count", 0, 0, 0, 0, {}, n)


def test_host_frame_reader():
    read = _reader("host_frame_ms.stream")
    assert read({}) is None
    # two frames of 30 and 50 ms, 10 ms and 25 ms of each the wait; a wait
    # outside any frame (the last of a multi-stream run) is not subtracted
    trace.absorb(None, [_span("serve.readback_wait", 0, 10, 2, 1), _span("serve.frame", 0, 30, 1),
                        _span("serve.readback_wait", 30, 55, 4, 3),
                        _span("serve.step", 55, 60, 5, 3), _span("serve.frame", 30, 80, 3),
                        _span("serve.readback_wait", 80, 90, 6), _count("serve.frames", 2)])
    assert read({}) == pytest.approx((20 + 25) / 2)
    trace.reset()
    trace.absorb(None, [_span("serve.frame", 0, 30, 1)])          # no counter: nothing
    assert read({}) is None


def test_host_step_reader_takes_the_slowest_rank():
    read = _reader("host_step_ms.train")
    assert read({}) is None
    for rank, (step_ms, upload_ms) in enumerate([(100, 30), (120, 10)]):
        recs = []
        for k in range(3):
            t = 200 * k
            recs += [_span("train.upload", t, t + upload_ms, 2 * k + 2, 2 * k + 1),
                     _span("train.step", t, t + step_ms, 2 * k + 1), _count("train.steps", 1)]
        trace.absorb(rank, recs)                # the same span ids on every rank
    assert read({}) == pytest.approx(110.0)
    trace.reset()
    trace.absorb(0, [_span("train.step", 0, 5, 1)])               # no counter: nothing
    assert read({}) is None


def test_threads_lose_no_record(monkeypatch):
    """Spans from more threads than cores, switching often: every one is
    kept or counted as dropped, and each thread's spans nest in its own."""
    import sys
    import threading

    monkeypatch.setattr(trace, "MAX_RECORDS", 5000)
    threads, each = 2 * (os.cpu_count() or 4), 400

    def work():
        for i in range(each):
            with trace.span("data.wait", frame=i):
                with trace.span("serve.step"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    trace.enable()
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    recs = trace.records()
    assert len(recs) == 5000 and len(recs) + trace.dropped() == 2 * threads * each
    kept = {r.id: r for r in recs}
    assert len(kept) == len(recs)                                   # ids unique
    for r in recs:
        if r.name == "data.wait":
            assert r.parent == 0
        else:                   # inside its own thread's data.wait, where that was kept
            outer = kept.get(r.parent)
            assert r.parent != 0 and (outer is None or (
                outer.name == "data.wait" and outer.start_ns <= r.start_ns <= r.end_ns
                <= outer.end_ns))
