"""The port's MultiStreamEvaluator: round-robin B=1 steps, one bank per
stream, on one CUDA stream (here the CPU).  As tests/test_multistream.py
holds for the JAX package: three streams of different lengths, one at
another resolution, one a repeat of another, at scale 4.

  * Each stream's alphas and trimaps equal the port's serial `run_video`
    of its clip bit for bit, and the repeated stream equals its twin.
  * Against the JAX package's MultiStreamEvaluator with the same weights
    (convert.from_jax): frame 0 within 1e-3; later frames at most 1% of
    values off by more than 1e-3 and at least 99% of labels agreeing
    (tests/test_torch_stream.py's tolerances and argument).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from otvm_tpu.eval import runner as jrunner
from otvm_tpu_torch.convert import from_jax
from otvm_tpu_torch.eval.runner import EvalProtocol, MultiStreamEvaluator
from tests.torch_port import jax_joint_variables, one_thread  # noqa: F401

SCALE = 4
PROTO = dict(memory_max_num=2, memory_skip_frame=3, scale=SCALE)


def _clip(seed, n, h, w):
    rng = np.random.RandomState(seed)
    frames = [rng.rand(h, w, 3).astype(np.float32) for _ in range(n)]
    tri = np.zeros((h, w, 3), np.float32)
    tri[..., 0] = 1
    tri[h // 4:-h // 4, w // 4:-w // 4] = (0, 1, 0)
    tri[3 * h // 8:-3 * h // 8, 3 * w // 8:-3 * w // 8] = (0, 0, 1)
    return dict(frames=frames, first_trimap=tri)


@pytest.fixture(scope="module")
def runs():
    stm_vars, fba_vars = jax_joint_variables(4, SCALE, 64, 64, seed=5)
    stm_sd, fba_sd = from_jax(stm_vars, fba_vars, stage=4, scale=SCALE)
    # lengths 5, 3, 5; stream 1 at another resolution; stream 2 repeats stream 0
    videos = [_clip(1, 5, 32, 64), _clip(2, 3, 64, 64), _clip(1, 5, 32, 64)]
    ev = MultiStreamEvaluator(stm_sd, fba_sd, EvalProtocol(**PROTO), device="cpu")
    port, fps = ev.run_videos(videos)
    assert fps > 0
    want, _ = jrunner.MultiStreamEvaluator(stm_vars, fba_vars,
                                           jrunner.EvalProtocol(**PROTO)).run_videos(videos)
    return ev, videos, port, want


def test_multistream_equals_serial_bit_for_bit(runs):
    ev, videos, port, _ = runs
    assert [len(a) for a, _ in port] == [5, 3, 5]
    for k, v in enumerate(videos):
        alphas, trimaps, _ = ev.run_video(v["frames"], v["first_trimap"])
        h, w = v["frames"][0].shape[:2]
        for i in range(len(v["frames"])):
            assert port[k][0][i].shape == (h, w) and port[k][1][i].shape == (h, w, 3)
            np.testing.assert_array_equal(port[k][0][i], alphas[i], err_msg=f"{k} {i}")
            np.testing.assert_array_equal(port[k][1][i], trimaps[i], err_msg=f"{k} {i}")
    for i in range(5):                                   # no leak between streams
        np.testing.assert_array_equal(port[0][0][i], port[2][0][i])
        np.testing.assert_array_equal(port[0][1][i], port[2][1][i])


def test_multistream_matches_jax(runs):
    _, videos, port, want = runs
    for k in range(len(videos)):
        for i in range(len(videos[k]["frames"])):
            for got, ref, what in ((port[k][0][i], want[k][0][i], "alpha"),
                                   (port[k][1][i], want[k][1][i], "trimap")):
                bad = np.abs(got - ref) > 1e-3
                if i == 0:
                    assert not bad.any(), f"stream {k} {what} frame 0"
                else:
                    assert bad.mean() <= 0.01, f"stream {k} {what} frame {i}: {bad.mean():.3%}"
            agree = (port[k][1][i].argmax(-1) == want[k][1][i].argmax(-1)).mean()
            assert agree == 1.0 if i == 0 else agree >= 0.99, f"stream {k} labels frame {i}"


def test_multistream_refuses_the_given_trimap_stages():
    from otvm_tpu_torch.models.otvm import init_models

    _, fba = init_models(seed=0, stage=2, scale=SCALE)
    ev = MultiStreamEvaluator(None, fba.state_dict(), EvalProtocol(stage=2, scale=SCALE),
                              device="cpu")
    with pytest.raises(ValueError, match="joint path"):
        ev.run_videos([_clip(1, 2, 32, 32)])


def test_multistream_bench_tool(capsys):
    """tools/multistream_bench.py (scripts/multistream_bench.py's flags as
    options) on the CPU at a small size: its JSON line, and the frames it
    cycles drawn as the JAX script draws them."""
    import json

    from otvm_tpu_torch.tools import multistream_bench as bench

    out = bench.main(["--device", "cpu", "--streams", "2", "--res", "64x64", "--frames", "3",
                      "--dtype", "fp32"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["metric"] == "fps_64x64_2streams_wire_joint_s4" and out["value"] > 0
    assert (out["streams"], out["dtype"], out["device"]) == (2, "fp32", "cpu")
    video = bench.make_video(1, 6, 32, 48)
    rng = np.random.RandomState(1)
    unique = [rng.rand(32, 48, 3).astype(np.float32) for _ in range(4)]
    assert all(np.array_equal(f, unique[i % 4]) for i, f in enumerate(video["frames"]))
    np.testing.assert_array_equal(video["first_trimap"], _clip(0, 1, 32, 48)["first_trimap"])
