"""The port's other eval paths against its own per-frame stream and the JAX
package's, with the same weights (convert.from_jax), fp32 on the CPU, at
full width and 32x64 (the JAX package's chunked, given-trimap and
trimap-only steps build the full-width models only):

  * `eval_chunk_step` (chunks of 3, and of 4 with a short tail) equals the
    port's per-frame `eval_frame_step` bit for bit, bank and count
    included; the chunked `StreamingEvaluator` equals the per-frame one,
    and JAX's chunked stream to the stream tolerances below;
  * `alpha_predict` (stages 1 and 2, the given-trimap path) and the
    stage-1/2 `StreamingEvaluator` within 1e-3 of JAX's;
  * `trimap_eval_step` with `memorize_gt` both ways and `TrimapEvaluator`
    against JAX's: counts and eviction equal, trimaps within 1e-3 on
    frame 0 and to the stream tolerances after;
  * stage routing, the protocol's `trimap_width` reaching the scored
    mask (and an unknown width refused), outputs copied
    out of the host buffers, and `frame_window_indices` /
    `load_frame_window`.

Stream tolerances (tests/test_torch_stream.py's argument): frame 0 reads
the GT trimap, every value within 1e-3; later frames read a propagated
trimap through an argmax, where random weights leave near-ties, so at most
1% of values may differ by more than 1e-3 and at least 99% of labels agree.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from otvm_tpu.eval import runner as jrunner
from otvm_tpu.models import otvm as jotvm
from otvm_tpu_torch.convert import fba_from_jax, from_jax, stm_from_jax
from otvm_tpu_torch.eval.runner import (EvalProtocol, StreamingEvaluator, TrimapEvaluator,
                                        _Device, frame_window_indices, load_frame_window)
from otvm_tpu_torch.models.otvm import (alpha_predict, eval_chunk_step, eval_frame_step,
                                        init_models, make_eval_bank, trimap_eval_step)
from tests.torch_port import jax_joint_variables

H, W, N = 32, 64, 6
PROTO = dict(memory_max_num=2, memory_skip_frame=3)


def _video(n, seed, h=H, w=W):
    """Smooth seeded frames (a coarse random grid, bilinearly upsampled)
    and a nested-box first trimap."""
    rng = np.random.RandomState(seed)
    ys, xs = np.linspace(0, 3, h), np.linspace(0, 3, w)
    y0, x0 = np.minimum(ys.astype(int), 2), np.minimum(xs.astype(int), 2)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    frames = []
    for _ in range(n):
        g = rng.rand(4, 4, 3)
        top = g[y0][:, x0] * (1 - fx) + g[y0][:, x0 + 1] * fx
        bot = g[y0 + 1][:, x0] * (1 - fx) + g[y0 + 1][:, x0 + 1] * fx
        frames.append((top * (1 - fy) + bot * fy).astype(np.float32))
    tri = np.zeros((h, w, 3), np.float32)
    tri[..., 0] = 1
    tri[h // 4:-h // 4, w // 4:-w // 4] = (0, 1, 0)
    tri[3 * h // 8:-3 * h // 8, 3 * w // 8:-3 * w // 8] = (0, 0, 1)
    return frames, tri


def _stream_close(got, want, frame, what):
    bad = np.abs(np.asarray(got) - np.asarray(want)) > 1e-3
    if frame == 0:
        assert not bad.any(), f"{what} frame 0: {bad.sum()} values off by more than 1e-3"
    else:
        assert bad.mean() <= 0.01, f"{what} frame {frame}: {bad.mean():.3%} off by > 1e-3"


def _labels_agree(got, want, frame):
    agree = (np.asarray(got).argmax(-1) == np.asarray(want).argmax(-1)).mean()
    assert agree == 1.0 if frame == 0 else agree >= 0.99, f"labels frame {frame}: {agree:.3%}"


@pytest.fixture(scope="module")
def joint():
    stm_vars, fba_vars = jax_joint_variables(4, 1, H, W, seed=5)    # test_torch_stream.py's
    return stm_vars, fba_vars, from_jax(stm_vars, fba_vars, stage=4)


def _u8(frames):
    return np.rint(np.stack(frames) * 255.0).astype(np.uint8)


@pytest.mark.parametrize("chunk", [3, 4])
def test_chunk_step_equals_frame_steps_bit_for_bit(joint, chunk):
    _, _, (stm_sd, fba_sd) = joint
    ev = StreamingEvaluator(stm_sd, fba_sd, EvalProtocol(**PROTO), device="cpu")
    frames, tri = _video(N, 22)
    flags, max_num, _ = EvalProtocol(**PROTO).flags(N, H, W)
    u8 = torch.from_numpy(_u8(frames))[:, None]                     # [N, 1, H, W, 3]
    first_tri = torch.from_numpy(tri[None])
    one = make_eval_bank(1, H, W, max_num, device="cpu")
    alphas, trimaps = [], []
    for i, (first, mem, last) in enumerate(flags):
        out = eval_frame_step(ev.stm, ev.fba, one, u8[i], first_tri, first, mem, last, max_num)
        one = out.bank
        alphas.append(out.alpha)
        trimaps.append(out.trimap)
    many = make_eval_bank(1, H, W, max_num, device="cpu")
    got_a, got_t = [], []
    for lo in range(0, N, chunk):
        first, mem, last = zip(*flags[lo:lo + chunk])
        many, a, t = eval_chunk_step(ev.stm, ev.fba, many, u8[lo:lo + chunk], first_tri, first,
                                     mem, last, max_num)
        assert a.shape == (len(first), 1, H, W, 1) and t.shape == (len(first), 1, H, W, 3)
        got_a += list(a)
        got_t += list(t)
    for i in range(N):
        assert torch.equal(got_a[i], alphas[i]) and torch.equal(got_t[i], trimaps[i]), i
    assert many.count == one.count
    assert torch.equal(many.keys, one.keys) and torch.equal(many.values, one.values)
    # the evaluator's chunked path gives its per-frame path's outputs
    a1, t1, _ = ev.run_video(frames, tri)
    ac, tc, _ = StreamingEvaluator(stm_sd, fba_sd, EvalProtocol(chunk=chunk, **PROTO),
                                   device="cpu").run_video(frames, tri)
    assert len(ac) == N and all(x.dtype == np.float32 for x in ac + tc)
    for i in range(N):
        np.testing.assert_array_equal(ac[i], a1[i])
        np.testing.assert_array_equal(tc[i], t1[i])


def test_chunked_stream_matches_jax(joint):
    """Chunks of 4 over 6 frames: JAX pads its tail chunk with last-frame
    repeats that leave the bank alone; the port runs the 2 real frames."""
    stm_vars, fba_vars, (stm_sd, fba_sd) = joint
    frames, tri = _video(N, 23)
    flags, max_num, _ = EvalProtocol(**PROTO).flags(N, H, W)
    ja, jt = [], []
    jbank = jotvm.make_eval_bank(1, H, W, max_num)
    for lo in range(0, N, 4):
        fl = list(flags[lo:lo + 4])
        fs = list(_u8(frames[lo:lo + 4]))
        while len(fs) < 4:
            fs.append(fs[-1])
            fl.append((False, False, True))
        jbank, a, t = jotvm.eval_chunk_step(
            stm_vars, fba_vars, jbank, jnp.asarray(np.stack(fs)[:, None]), jnp.asarray(tri[None]),
            *(jnp.asarray([f[k] for f in fl]) for k in range(3)), max_memory_num=max_num)
        ja += list(np.asarray(a)[:min(4, N - lo), 0, ..., 0])
        jt += list(np.asarray(t)[:min(4, N - lo), 0])
    ev = StreamingEvaluator(stm_sd, fba_sd, EvalProtocol(chunk=4, **PROTO), device="cpu")
    ta, tt, _ = ev.run_video(frames, tri)
    for i in range(N):
        _stream_close(ta[i], ja[i], i, "alpha")
        _stream_close(tt[i], jt[i], i, "trimap")
        _labels_agree(tt[i], jt[i], i)
    # the bank's count after the padded tail is the unpadded one
    pbank = make_eval_bank(1, H, W, max_num, device="cpu")
    for lo in range(0, N, 4):
        first, mem, last = zip(*flags[lo:lo + 4])
        chunk = torch.from_numpy(_u8(frames[lo:lo + 4]))[:, None]
        pbank = eval_chunk_step(ev.stm, ev.fba, pbank, chunk, torch.from_numpy(tri[None]),
                                first, mem, last, max_num)[0]
    assert pbank.count == int(jbank.count)


@pytest.mark.parametrize("stage", [1, 2])
def test_alpha_predict_matches_jax(stage):
    _, fba_vars = jax_joint_variables(stage, 1, H, W, seed=30 + stage)
    frames, tri = _video(3, 31)
    gts = [tri, tri[:, ::-1].copy(), np.roll(tri, 5, axis=1)]
    jev = jrunner.StreamingEvaluator(None, fba_vars, jrunner.EvalProtocol(stage=stage))
    ja, jt, _ = jev.run_video(frames, tri, gt_trimaps=gts)
    ev = StreamingEvaluator(None, fba_from_jax(fba_vars, refinement=False),
                            EvalProtocol(stage=stage), device="cpu")
    ta, tt, _ = ev.run_video(frames, tri, gt_trimaps=gts)
    assert len(ta) == len(ja) == 3 and len(tt) == 3
    for i in range(3):
        np.testing.assert_allclose(ta[i], ja[i], atol=1e-3, rtol=0)
        assert tt[i] is gts[i]                       # the given trimaps come back
    # the step itself, on a soft trimap: alpha and all 7 channels
    soft = np.random.RandomState(32).dirichlet(np.ones(3), (1, H, W)).astype(np.float32)
    u8 = _u8(frames[:1])
    ja1, j7 = jotvm.alpha_predict(fba_vars, jnp.asarray(u8), jnp.asarray(soft), stage=stage)
    ta1, t7 = alpha_predict(ev.fba, torch.from_numpy(u8), torch.from_numpy(soft))
    assert ta1.shape == (1, H, W, 1) and t7.shape == (1, H, W, 7)
    np.testing.assert_allclose(ta1.numpy(), np.asarray(ja1), atol=1e-3, rtol=0)
    np.testing.assert_allclose(t7.numpy(), np.asarray(j7), atol=1e-3, rtol=0)


def test_stage_1_2_runs_without_a_trimap_state():
    """No trimap network at stages 1-2: None or {} for its state; without
    per-frame trimaps only frame 0 (whose trimap is given) runs."""
    _, fba = init_models(seed=3, stage=2, scale=4)
    frames, tri = _video(3, 33, 64, 64)
    for state in (None, {}):
        ev = StreamingEvaluator(state, fba.state_dict(), EvalProtocol(stage=2, scale=4),
                                device="cpu")
        assert ev.stm is None
        alphas, trimaps, _ = ev.run_video(frames, tri)
        assert len(alphas) == 1 and trimaps[0] is tri
        assert alphas[0].shape == (64, 64) and 0.0 <= alphas[0].min() <= alphas[0].max() <= 1.0
        alphas, _, _ = ev.run_video(frames, tri, gt_trimaps=[tri] * 5)
        assert len(alphas) == 3


def test_protocol_rejects_an_unapplied_trimap_width(tmp_path, monkeypatch):
    """evaluate_vm108 scores each clip on the unknown region of its GT
    trimaps dilated by the protocol's width, radius 5 / 12 / 20
    (config.TRIMAP_WIDTH_KERNELS); a width without a radius raises."""
    import json

    import cv2

    from otvm_tpu_torch.data.trimap import trimap_from_alpha
    from otvm_tpu_torch.eval import runner

    base = tmp_path / "VideoMatting108"
    yy, xx = np.mgrid[:48, :48]
    gt = [np.clip((12 - np.hypot(yy - 24, xx - 20 - 2 * i)) / 3, 0, 1) for i in range(2)]
    for d in ("FG_done", "BG_done2"):
        (base / d / "c").mkdir(parents=True)
    for i, a in enumerate(gt):
        cv2.imwrite(str(base / "FG_done" / "c" / f"{i}.png"),
                    np.dstack([np.full((48, 48, 3), 200, np.uint8), (a * 255).astype(np.uint8)]))
        cv2.imwrite(str(base / "BG_done2" / "c" / f"{i}.png"), np.zeros((48, 48, 3), np.uint8))
    (base / "frame_corr.json").write_text(json.dumps({f"c/{i}.png": f"c/{i}.png" for i in range(2)}))
    (base / "val_videos.txt").write_text("c")
    masks = []
    monkeypatch.setattr(runner, "video_metrics", lambda p, t, m: masks.append(m) or {"SAD": 0.0})

    class Given:                      # the GT alphas back, as an evaluator would return them
        def __init__(self, width):
            self.protocol = EvalProtocol(trimap_width=width)

        def run_video(self, frames, tri, out_dir=None, filenames=None, gt_trimaps=None):
            return [f.mean(-1) for f in frames], None, 1.0

    for width, radius in (("narrow", 5), ("medium", 12), ("wide", 20)):
        assert runner.evaluate_vm108(Given(width), str(tmp_path))["videos"] == 1
        alphas = [(a * 255).astype(np.uint8) / 255.0 for a in gt]
        want = np.stack([trimap_from_alpha(a, radius)[..., 1] for a in alphas]) * 128.0
        np.testing.assert_array_equal(masks[-1], want)
    assert masks[0].sum() < masks[1].sum() < masks[2].sum()
    assert EvalProtocol().trimap_width == "medium"
    for width in ("thin", "Medium", ""):
        with pytest.raises(ValueError, match="trimap_width"):
            EvalProtocol(trimap_width=width)


def test_fetched_outputs_own_their_memory():
    """The evaluators hand out copies, so the (pinned) host buffers a step's
    outputs land in go back to the allocator instead of living on."""
    host = torch.arange(6, dtype=torch.float32)
    got, = _Device._fetch(([host], None))
    assert not np.shares_memory(got, host.numpy())
    host.zero_()
    assert got.tolist() == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]


@pytest.fixture(scope="module")
def stm1():
    stm_vars = jax_joint_variables(1, 1, H, W, seed=40)[0]
    return stm_vars, stm_from_jax(stm_vars, hdim=-1)


def test_trimap_evaluator_matches_jax(stm1):
    stm_vars, stm_sd = stm1
    frames, tri = _video(N, 41)
    jt, _ = jrunner.TrimapEvaluator(stm_vars, jrunner.EvalProtocol(**PROTO)).run_video(frames, tri)
    tt, _ = TrimapEvaluator(stm_sd, EvalProtocol(**PROTO), device="cpu").run_video(frames, tri)
    assert len(tt) == len(jt) == N
    np.testing.assert_array_equal(tt[0], tri)
    for i in range(N):
        assert tt[i].shape == (H, W, 3) and tt[i].dtype == np.float32
        _stream_close(tt[i], jt[i], i, "trimap")
        _labels_agree(tt[i], jt[i], i)


@pytest.mark.parametrize("memorize_gt", [False, True])
def test_trimap_eval_step_matches_jax(stm1, memorize_gt):
    """Every frame memorized; a bank of at most 2 and a memorize every 3rd
    frame overflow at frame 3, which evicts slot 1 (slot 0 kept), or slot
    0 with memorize_gt."""
    stm_vars, stm_sd = stm1
    stm = TrimapEvaluator(stm_sd, EvalProtocol(**PROTO), device="cpu").stm
    frames, tri = _video(N, 42)
    flags, max_num, _ = EvalProtocol(**PROTO).flags(N, H, W)
    jbank = jotvm.make_eval_bank(1, H, W, max_num)
    pbank = make_eval_bank(1, H, W, max_num, device="cpu")
    first_keys = None
    for i, (first, mem, _) in enumerate(flags):
        jbank, jpred = jotvm.trimap_eval_step(
            stm_vars, jbank, jnp.asarray(frames[i][None]), jnp.asarray(tri[None]),
            jnp.asarray(first), jnp.asarray(mem), max_memory_num=max_num, memorize_gt=memorize_gt)
        pbank, ppred = trimap_eval_step(stm, pbank, torch.from_numpy(frames[i][None]),
                                        torch.from_numpy(tri[None]), first, mem, max_num,
                                        memorize_gt=memorize_gt)
        assert pbank.count == int(jbank.count), i
        _stream_close(ppred.numpy(), np.asarray(jpred), i, "trimap")
        _labels_agree(ppred.numpy(), np.asarray(jpred), i)
        if first:
            first_keys = pbank.keys[:, 0].clone()
        if memorize_gt:   # the memories are of the GT trimap: the same on both sides
            scale = float(np.abs(np.asarray(jbank.keys)).max())
            np.testing.assert_allclose(pbank.keys[:, :pbank.count].numpy(),
                                       np.asarray(jbank.keys)[:, :pbank.count],
                                       atol=1e-4 * scale, rtol=0)
    assert [f[1] for f in flags[:4]] == [True, False, False, True] and pbank.count == 2
    # frame 3 overflowed: slot 0 is frame 0's memory unless memorize_gt evicted it
    assert torch.equal(pbank.keys[:, 0], first_keys) != memorize_gt


@pytest.mark.parametrize("idx,num,total", [(0, 3, 10), (5, 3, 10), (9, 3, 10), (5, 4, 10),
                                           (0, 4, 10), (9, 4, 10), (1, 5, 3), (0, 1, 1)])
def test_frame_window_matches_jax(idx, num, total):
    np.testing.assert_array_equal(frame_window_indices(idx, num, total),
                                  jrunner.frame_window_indices(idx, num, total))
    frames = [np.full((2, 3, 1), k, np.float32) for k in range(total)]
    got, centre = load_frame_window(frames, idx, num)
    want, want_centre = jrunner.load_frame_window(frames, idx, num)
    np.testing.assert_array_equal(got, want)
    assert centre == want_centre
