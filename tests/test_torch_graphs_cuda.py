"""The serving step from CUDA graphs (otvm_tpu_torch/models/graphs.py) on a
CUDA card, against the eager step, at scale 4 on 64x64 frames and at full
width on 512x512:

  * graphed run_video, the chunked step and multi-stream serving give the
    eager path's outputs bit for bit (the same kernels in the same order),
    and so do trimap propagation alone (memorize_gt too) and stage 2 on
    given trimaps;
  * the read's launch counters count each replay's reads, and not the
    captures: one read a segment call on either path;
  * a capture under a lockstep check raises, as does a replay;
  * the JFA run inline inside a capture gives its own graph's bits, and
    the capture leaves its graph cache alone;
  * a bucket holds no more graphs than `max_graphs`, and the cache no more
    buckets than `MAX_BUCKETS`.

Needs a card and no JAX:
`python -m pytest --noconftest -m cuda tests/test_torch_graphs_cuda.py`."""
import numpy as np
import pytest
import torch

from otvm_tpu_torch.eval.runner import (EvalProtocol, MultiStreamEvaluator, StreamingEvaluator,
                                        TrimapEvaluator)
from otvm_tpu_torch.kernels import memory_attn as ma
from otvm_tpu_torch.models import graphs as graphs_module
from otvm_tpu_torch.models.graphs import FrameStepGraphs, max_graphs
from otvm_tpu_torch.models.otvm import (eval_chunk_step, init_models, make_eval_bank,
                                        trimap_eval_step)
from otvm_tpu_torch.nn import edt
from otvm_tpu_torch.tools.kernel_check import lockstep_check

SIZES = [pytest.param(4, 64, id="scale4-64"), pytest.param(1, 512, id="full-512")]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _clip(n, size, seed):
    rng = np.random.RandomState(seed)
    frames = [rng.rand(size, size, 3).astype(np.float32) for _ in range(n)]
    tri = np.zeros((size, size, 3), np.float32)
    tri[..., 0] = 1.0
    tri[size // 4:-size // 4, size // 4:-size // 4] = (0, 1, 0)
    tri[3 * size // 8:-3 * size // 8, 3 * size // 8:-3 * size // 8] = (0, 0, 1)
    return frames, tri


def _evaluators(scale, dtype="bf16", evaluator=StreamingEvaluator):
    """(eager, graphed) evaluators of one stage-4 model's random weights."""
    stm, fba = init_models(seed=scale, stage=4, scale=scale)
    p = EvalProtocol(memory_max_num=3, memory_skip_frame=4, scale=scale, dtype=dtype)
    return tuple(evaluator(stm.state_dict(), fba.state_dict(), p, graphs=graphs)
                 for graphs in (False, None))


def _same(xs, ys):
    return len(xs) == len(ys) and all(np.array_equal(x, y) for x, y in zip(xs, ys))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("scale,size", SIZES)
def test_graphed_stream_equals_eager_and_counts_replays(scale, size, dtype):
    _cuda()
    eager, graphed = _evaluators(scale, dtype)
    frames, tri = _clip(14, size, seed=1)
    torch.cuda.synchronize()
    ma.launches = 0
    ea, et, _ = eager.run_video(frames, tri)
    assert ma.launches == len(frames) - 1
    for turn in range(2):                  # captures, then replays only
        before = graphed.step_graphs.captures
        ma.launches = 0
        ga, gt, _ = graphed.run_video(frames, tri)
        assert ma.launches == len(frames) - 1, turn
        assert _same(ga, ea) and _same(gt, et), turn
        assert (graphed.step_graphs.captures > before) == (turn == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("scale,size", SIZES)
def test_graphed_chunks_and_multistream_equal_eager(scale, size):
    _cuda()
    eager, graphed = _evaluators(scale)
    frames, tri = _clip(11, size, seed=2)
    ea, et, _ = eager.run_video(frames, tri)
    # the chunked step: chunks of 4 from the graphs, frame for frame the eager stream
    g, ev = graphed.step_graphs, graphed
    flags, max_num, _ = ev.protocol.flags(len(frames), size, size)
    u8 = torch.from_numpy(np.rint(np.stack(frames) * 255).astype(np.uint8)).cuda()[:, None]
    first_tri = torch.from_numpy(tri[None]).cuda().to(ev.dtype)
    bank, alphas, trimaps = g.bank(1, size, size, max_num, ev.dtype), [], []
    ma.launches = 0
    for lo in range(0, len(frames), 4):
        first, mem, last = zip(*flags[lo:lo + 4])
        bank, a, t = eval_chunk_step(ev.stm, ev.fba, bank, u8[lo:lo + 4], first_tri, first, mem,
                                     last, max_num, graphs=g)
        alphas += [x[0, ..., 0].float().cpu().numpy() for x in a]
        trimaps += [x[0].float().cpu().numpy() for x in t]
    assert ma.launches == len(frames) - 1
    assert _same(alphas, ea) and _same(trimaps, et)
    # three streams round-robin, one shorter and one a repeat
    clips = [dict(frames=frames, first_trimap=tri), dict(frames=frames[:5], first_trimap=tri[::-1]),
             dict(frames=frames, first_trimap=tri)]
    multi = _evaluators(scale, evaluator=MultiStreamEvaluator)
    want = multi[0].run_videos(clips)[0]
    ma.launches = 0
    got = multi[1].run_videos(clips)[0]
    assert ma.launches == 2 * (len(frames) - 1) + 4
    for (ga, gt), (wa, wt) in zip(got, want):
        assert _same(ga, wa) and _same(gt, wt)
    assert _same(got[0][0], ea) and _same(got[2][0], ea)


@pytest.mark.cuda
@pytest.mark.parametrize("scale,size", SIZES)
def test_graphed_trimap_and_given_trimap_steps_equal_eager(scale, size):
    _cuda()
    frames, tri = _clip(9, size, seed=6)
    p = EvalProtocol(memory_max_num=3, memory_skip_frame=4, scale=scale)
    stm1 = init_models(seed=6, stage=1, scale=scale)[0].state_dict()
    eager, graphed = (TrimapEvaluator(stm1, p, graphs=graphs) for graphs in (False, None))
    want = eager.run_video(frames, tri)[0]
    for turn in range(2):
        ma.launches = 0
        got = graphed.run_video(frames, tri)[0]
        assert ma.launches == len(frames) - 1 and _same(got, want), turn
    # memorize_gt: every frame memorized with the first trimap, an input of the graphs
    bank_e, bank_g = (make_eval_bank(1, size, size, 2, scale=scale),
                      graphed.step_graphs.bank(1, size, size, 2))
    first = torch.from_numpy(tri[None]).cuda()
    for i in range(6):
        f = torch.from_numpy(frames[i][None]).cuda()
        bank_e, pe = trimap_eval_step(eager.stm, bank_e, f, first, i == 0, i % 3 == 0, 2,
                                      memorize_gt=True)
        bank_g, pg = graphed.step_graphs(bank_g, f, first, i == 0, i % 3 == 0, 2,
                                         memorize_gt=True)
        assert torch.equal(pe, pg) and bank_e.count == bank_g.count, i
    assert torch.equal(bank_e.keys, bank_g.keys) and torch.equal(bank_e.values, bank_g.values)
    # stage 2: FBA alone on given trimaps, one graph a shape
    fba2 = init_models(seed=7, stage=2, scale=scale)[1].state_dict()
    gts = [tri, tri[::-1].copy(), tri[:, ::-1].copy(), tri]
    given = [StreamingEvaluator(None, fba2, EvalProtocol(stage=2, scale=scale), graphs=graphs)
             for graphs in (False, None)]
    want = given[0].run_video(frames[:4], tri, gt_trimaps=gts)[0]
    ma.launches = 0
    assert _same(given[1].run_video(frames[:4], tri, gt_trimaps=gts)[0], want)
    assert ma.launches == 0 and given[1].step_graphs.graphs_per_bucket() == [1]


@pytest.mark.cuda
@pytest.mark.parametrize("scale,size", SIZES)
def test_lockstep_check_refuses_a_capture_and_a_replay(scale, size):
    _cuda()
    eager, graphed = _evaluators(scale)
    frames, tri = _clip(4, size, seed=3)
    with lockstep_check(torch.bfloat16) as errs:
        eager.run_video(frames, tri)
    assert len(errs) == 3
    with pytest.raises(RuntimeError, match="lockstep_check"):
        with lockstep_check(torch.bfloat16):
            graphed.run_video(frames, tri)          # frame 1's capture
    graphed.run_video(frames, tri)                  # captured without the check
    with pytest.raises(RuntimeError, match="lockstep check is active"):
        with lockstep_check(torch.bfloat16):
            graphed.run_video(frames, tri)          # frame 1's replay
    assert ma.host_checks == 0


@pytest.mark.cuda
def test_jfa_inline_in_a_capture_equals_its_own_graph():
    _cuda()
    grid = torch.from_numpy(np.random.RandomState(4).rand(2, 1, 9, 9).astype(np.float32))
    seeds = (torch.nn.functional.interpolate(grid, size=(96, 80), mode="bilinear",
                                             align_corners=True)[:, 0] > 0.5).cuda()
    want = edt.edt_sq_jfa(seeds)                    # its own per-shape graph
    cached = {key: entry[2] for key, entry in edt._graphs.items()}
    static = torch.zeros_like(seeds)
    stream = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = edt.edt_sq_jfa(static)
    # no nested capture: the JFA's own graphs are the ones it had
    assert {key: entry[2] for key, entry in edt._graphs.items()} == cached
    static.copy_(seeds)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_graphs_stay_within_their_caps(monkeypatch):
    """Seeded flags with a new clip every 6 frames meet all 9 keys of a
    bank of 3 (counts 1-3: memorize, not, last); then three more frame
    sizes under MAX_BUCKETS 2 keep the last two buckets."""
    _cuda()
    monkeypatch.setattr(graphs_module, "MAX_BUCKETS", 2)
    stm, fba = (m.cuda().eval().requires_grad_(False)
                for m in init_models(seed=5, stage=4, scale=4))
    graphs = FrameStepGraphs(stm, fba)
    frames, tri = _clip(60, 64, seed=5)
    u8 = torch.from_numpy(np.rint(np.stack(frames) * 255).astype(np.uint8)).cuda()[:, None]
    first_tri = torch.from_numpy(tri[None]).cuda()
    rng = np.random.RandomState(5)
    bank, keys = graphs.bank(1, 64, 64, 3), set()
    for i in range(len(frames)):
        first = i % 6 == 0
        mem, last = bool(rng.rand() < 0.5), not first and bool(rng.rand() < 0.3)
        if not first:
            keys.add((bank.count, mem and not last, last))
        bank = graphs(bank, u8[i], first_tri, first, mem, last, max_memory_num=3).bank
        assert sum(graphs.graphs_per_bucket()) == len(keys) <= max_graphs(3)
    assert len(keys) == max_graphs(3) == 9
    for size in (32, 96, 128):
        f, t = _clip(3, size, seed=size)
        b = graphs.bank(1, size, size, 3)
        for i in range(3):
            b = graphs(b, torch.from_numpy(np.rint(f[i] * 255).astype(np.uint8)).cuda()[None],
                       torch.from_numpy(t[None]).cuda(), i == 0, False, False, 3).bank
        assert len(graphs.graphs_per_bucket()) <= 2
    assert graphs.graphs_per_bucket() == [2, 2]         # 96 and 128: counts 1 and 2
