"""The port's stage-4 stream (otvm_tpu_torch.eval.runner.StreamingEvaluator
on the CPU) against the JAX package's StreamingEvaluator with the same
weights (convert.from_jax), per frame, in fp32 and over the uint8 wire.

  * scale=4, 64x64, 8 frames, memorize every 3rd frame, a bank of at most
    2: the bank appends, rolls and evicts;
  * the full-width model at 32x64 over 4 frames: only full width runs
    layer3/4's dilated rest-blocks and 32-group GroupNorm.

Tolerances.  Frame 0 reads the GT trimap: every alpha and trimap value
within 1e-3 (fp32 summation order, amplified up to 10x where fba_fusion
divides by sum((F-B)^2) + 0.1).  Later frames read the propagated trimap
through an argmax.  Random weights leave many pixels where two class
probabilities tie within fp32 noise; where the argmax flips there, the
distance features move near that pixel.  So from frame 1 on, at most 1% of
pixels may differ by more than 1e-3, and at least 99% of trimap labels
agree.  Over the uint8 wire the same holds for alpha bytes differing by
more than one, and for labels.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from otvm_tpu.eval.runner import EvalProtocol as JProtocol
from otvm_tpu.eval.runner import StreamingEvaluator as JEvaluator
from otvm_tpu_torch.convert import from_jax
from otvm_tpu_torch.eval.runner import EvalProtocol, StreamingEvaluator
from tests.torch_port import jax_joint_variables

CASES = {
    "scale4": dict(scale=4, h=64, w=64, frames=8, skip=3, max_num=2),
    "full": dict(scale=1, h=32, w=64, frames=4, skip=3, max_num=2),
}


def _video(h, w, n, seed):
    """Smooth seeded frames (bilinear upsampling of a coarse random grid, a
    fresh grid per frame) and the bench's nested-box first trimap."""
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


@pytest.fixture(scope="module", params=list(CASES))
def streams(request):
    c = CASES[request.param]
    stm_vars, fba_vars = jax_joint_variables(4, c["scale"], c["h"], c["w"], seed=5)
    stm_sd, fba_sd = from_jax(stm_vars, fba_vars, stage=4, scale=c["scale"])
    frames, tri = _video(c["h"], c["w"], c["frames"], seed=6)
    out = {}
    for wire in (False, True):
        kw = dict(memory_max_num=c["max_num"], memory_skip_frame=c["skip"],
                  scale=c["scale"], wire_u8_out=wire)
        out["jax", wire] = JEvaluator(stm_vars, fba_vars, JProtocol(**kw)).run_video(frames, tri)
        out["torch", wire] = StreamingEvaluator(stm_sd, fba_sd, EvalProtocol(**kw),
                                                device="cpu").run_video(frames, tri)
    return c, out


def _mostly_close(got, want, atol, what, frame):
    bad = np.abs(got - want) > atol
    if frame == 0:
        assert not bad.any(), f"{what} frame 0: {bad.sum()} values off by more than {atol}"
    else:
        assert bad.mean() <= 0.01, f"{what} frame {frame}: {bad.mean():.3%} off by > {atol}"


def _labels_agree(got, want, frame):
    agree = (got == want).mean()
    assert agree == 1.0 if frame == 0 else agree >= 0.99, f"labels frame {frame}: {agree:.3%}"


def test_stream_fp32_matches_jax(streams):
    c, out = streams
    (ja, jt, _), (ta, tt, _) = out["jax", False], out["torch", False]
    assert len(ta) == len(ja) == c["frames"]
    for i in range(c["frames"]):
        assert ta[i].shape == (c["h"], c["w"]) and tt[i].shape == (c["h"], c["w"], 3)
        _mostly_close(ta[i], ja[i], 1e-3, "alpha", i)
        _mostly_close(tt[i], jt[i], 1e-3, "trimap", i)
        _labels_agree(tt[i].argmax(-1), jt[i].argmax(-1), i)


def test_stream_wire_u8_matches_jax(streams):
    c, out = streams
    (ja, jt, _), (ta, tt, _) = out["jax", True], out["torch", True]
    for i in range(c["frames"]):
        _mostly_close(np.rint(ta[i] * 255), np.rint(ja[i] * 255), 1, "alpha bytes", i)
        _labels_agree(tt[i].argmax(-1), jt[i].argmax(-1), i)
    # the wire stream follows the same trajectory as the fp32 stream
    fa = out["torch", False][0]
    for i in range(c["frames"]):
        np.testing.assert_array_equal(ta[i], np.round(np.clip(fa[i], 0, 1) * 255) / 255)


def test_bf16_drift_matches_jax():
    """bf16 serving drifts from fp32 as the JAX package's bf16 serving does,
    on the same flax-default random weights (full width, 64x64, frame 0:
    same input, GT trimap): the port's drift is within a factor 2 of JAX's,
    and the two bf16 outputs are no farther apart than 2x JAX's drift."""
    from otvm_tpu_torch.convert import to_jax
    from otvm_tpu_torch.models.otvm import init_models

    stm, fba = init_models(seed=0, stage=4)
    stm_sd, fba_sd = stm.state_dict(), fba.state_dict()
    stm_vars, fba_vars = to_jax(stm_sd, fba_sd, stage=4)
    frames, tri = _video(64, 64, 1, seed=7)
    alpha = {}
    for dt in ("fp32", "bf16"):
        alpha["jax", dt] = JEvaluator(stm_vars, fba_vars, JProtocol(dtype=dt)).run_video(
            frames, tri)[0][0]
        alpha["torch", dt] = StreamingEvaluator(stm_sd, fba_sd, EvalProtocol(dtype=dt),
                                                device="cpu").run_video(frames, tri)[0][0]
    mean_diff = lambda a, b: float(np.abs(alpha[a] - alpha[b]).mean())
    jax_drift = mean_diff(("jax", "bf16"), ("jax", "fp32"))
    port_drift = mean_diff(("torch", "bf16"), ("torch", "fp32"))
    assert mean_diff(("torch", "fp32"), ("jax", "fp32")) < 1e-4
    assert 0.5 * jax_drift <= port_drift <= 2.0 * jax_drift, (port_drift, jax_drift)
    assert mean_diff(("torch", "bf16"), ("jax", "bf16")) <= 2.0 * jax_drift
