"""The port's dataset evaluation and eval CLI against the JAX package's, on
a VideoMatting108 tree and a demo tree written here (64x96, 5 frames, 2
clips), fp32 on the CPU.

  * `iter_vm108_videos` / `iter_demo_videos` yield what JAX's yield,
    exactly (cv2 decodes both; the BG .png fallback included).
  * Given the same alphas, `_score_vm108_video`'s totals equal JAX's
    exactly, and the alpha PNGs, trimap PNGs and viz strips the evaluators
    write are byte-identical to JAX's (the model steps replaced by one
    function of the frame on both sides).
  * `evaluate_vm108` (stage 4, scale 4) and `evaluate_vm108_trimap` (the
    stage-1 STM, full width: JAX's trimap step builds only that) end to
    end, with JAX's weights carried over by convert.from_jax, against
    JAX's on the same clips: `videos` equal, each metric within
    METRIC_RTOL (below), at every trimap width; the widths change the
    score, and an unknown width raises.
  * The CLI's `main(argv)` with `--device cpu` (the model cut to scale 4
    through the CLI's get_cfg_defaults) on both trees: PNGs, viz strips
    and the printed JSON; `--streams 2` writes the bytes of `--streams 1`.
"""
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

from otvm_tpu.eval import runner as jrunner
from otvm_tpu_torch.cli import eval as cli_eval
from otvm_tpu_torch.config import get_cfg_defaults
from otvm_tpu_torch.convert import from_jax, stm_from_jax
from otvm_tpu_torch.eval import runner
from otvm_tpu_torch.eval.runner import (EvalProtocol, StreamingEvaluator, TrimapEvaluator,
                                        evaluate_vm108, evaluate_vm108_trimap)
from otvm_tpu_torch.models.otvm import init_models
from otvm_tpu_torch.models.stm import STM
from tests.torch_port import jax_joint_variables

H, W, N = 64, 96, 5
SCALE = 4
PROTO = dict(memory_max_num=2, memory_skip_frame=3)
# The end-to-end metrics come from the port's and JAX's alphas, which
# tests/test_torch_stream.py holds to 1e-3 on frame 0 and, later, to at
# most 1% of values off by more than 1e-3: fp32 summation order, and
# argmax near-ties of random weights that move a few pixels' distance
# features.  Those bounds on a 64x96 clip, pushed through the sums of
# SAD/MSE/SSDA and the local filters of Grad/Conn/MESSDdt, allow a few
# percent on any one metric; measured here they agree to 1e-7..8e-6
# relative (no label flips on these clips), so 1e-3 is held.
METRIC_RTOL = 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    """One torch and one cv2 thread a test: the suite runs several test
    processes at once, and each library's pool over every core would
    oversubscribe the host (every parallel region of the small models'
    many small ops then waits for descheduled threads)."""
    threads, cv_threads = torch.get_num_threads(), cv2.getNumThreads()
    torch.set_num_threads(1)
    cv2.setNumThreads(1)
    yield
    torch.set_num_threads(threads)
    cv2.setNumThreads(cv_threads)


def _alpha(seq: int, i: int) -> np.ndarray:
    yy, xx = np.mgrid[:H, :W]
    d = np.hypot(yy - H / 2 - i, xx - W / 2 - 2 * i - 6 * seq)
    return np.clip((14 + 2 * seq - d) / 5 + 0.5, 0, 1)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """VideoMatting108/ (both clips in val; clip 1's frame_corr names .jpg
    backgrounds stored as .png) and a demo tree (JPEG frames, the first
    frame's trimap as a gray PNG)."""
    root = tmp_path_factory.mktemp("eval_data")
    vm, demo = root / "vm", root / "demo"
    base = vm / "VideoMatting108"
    rng = np.random.RandomState(0)
    corr = {}
    for s, seq in enumerate(("clipA", "clipB")):
        for d in ("FG_done", "BG_done2"):
            (base / d / seq).mkdir(parents=True)
        (demo / seq / "frames").mkdir(parents=True)
        (demo / seq / "trimap").mkdir(parents=True)
        for i in range(N):
            fn = f"{seq}/{i:05d}.png"
            a = (_alpha(s, i) * 255).astype(np.uint8)
            fg = cv2.resize(rng.randint(0, 255, (8, 12, 3)).astype(np.uint8), (W, H))
            bg = cv2.resize(rng.randint(0, 255, (8, 12, 3)).astype(np.uint8), (W, H))
            cv2.imwrite(str(base / "FG_done" / fn), np.dstack([fg, a]))
            cv2.imwrite(str(base / "BG_done2" / fn), bg)
            corr[fn] = fn.replace(".png", ".jpg") if s == 1 else fn
            comp = (fg * (a[..., None] / 255.0) + bg * (1 - a[..., None] / 255.0)).astype(np.uint8)
            cv2.imwrite(str(demo / seq / "frames" / f"{i:05d}.jpg"), comp)
        tri = np.where(_alpha(s, 0) >= 1, 255, np.where(_alpha(s, 0) > 0, 128, 0))
        cv2.imwrite(str(demo / seq / "trimap" / "00000.png"), tri.astype(np.uint8))
    (base / "frame_corr.json").write_text(json.dumps(corr))
    (base / "val_videos.txt").write_text("clipA\nclipB\n")
    return str(vm), str(demo)


def _same_video(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, list) and v and isinstance(v[0], np.ndarray):
            assert len(got[k]) == len(v), k
            for g, w in zip(got[k], v):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w, err_msg=k)
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


def test_iterators_equal_jax(roots):
    vm, demo = roots
    for radius in (5, 12):
        got = list(runner.iter_vm108_videos(vm, "val", radius))
        want = list(jrunner.iter_vm108_videos(vm, "val", radius))
        assert [v["seq_name"] for v in got] == ["clipA", "clipB"]
        assert [len(v["frames"]) for v in got] == [N, N]
        for g, w in zip(got, want):
            _same_video(g, w)
    got, want = list(runner.iter_demo_videos(demo)), list(jrunner.iter_demo_videos(demo))
    assert len(got) == 2 and got[0]["frames"][0].shape == (H, W, 3)
    for g, w in zip(got, want):
        _same_video(g, w)


def test_scoring_equals_jax_on_the_same_alphas(roots):
    vm, _ = roots
    rng = np.random.RandomState(3)
    for radius in (5, 12, 20):
        totals, jtotals = {}, {}
        for vid in runner.iter_vm108_videos(vm, "val", radius):
            alphas = [np.clip(a + 0.2 * rng.randn(H, W), 0, 1).astype(np.float32)
                      for a in vid["gt_alpha"]]
            runner._score_vm108_video(vid, alphas, radius, totals)
            jrunner._score_vm108_video(vid, alphas, radius, jtotals)
        assert totals == jtotals and len(totals) == 7


def _files(d):
    out = {}
    for dirpath, _, names in os.walk(d):
        for n in names:
            p = os.path.join(dirpath, n)
            out[os.path.relpath(p, d)] = open(p, "rb").read()
    return out


def _fake_alpha(frame_u8: np.ndarray) -> np.ndarray:
    """[1, H, W, 3] bytes -> [1, H, W, 1] alpha reaching below 0 and above
    1, with fractional bytes (the writers clip and truncate)."""
    return (frame_u8[..., :1].astype(np.float32) / 255.0 * 1.3 - 0.15).astype(np.float32)


def _fake_trimap(frame01: np.ndarray) -> np.ndarray:
    lab = np.clip((frame01[..., 0] * 3).astype(np.int64), 0, 2)
    return np.eye(3, dtype=np.float32)[lab]


def test_writers_equal_jax_bytes(roots, tmp_path, monkeypatch):
    """The stage-2 evaluator's alpha PNGs and viz strips, and the trimap
    evaluator's label PNGs, from the same outputs: the same files and bytes
    as JAX's writers."""
    vm, _ = roots
    vid = next(runner.iter_vm108_videos(vm, "val", 12))
    gts = [runner.trimap_from_alpha(a, 12) for a in vid["gt_alpha"]]
    monkeypatch.setattr(jrunner, "alpha_predict", lambda v, f, t, **kw: (
        _fake_alpha(np.asarray(f)), None))
    monkeypatch.setattr(runner, "alpha_predict", lambda fba, f, t: (
        torch.from_numpy(_fake_alpha(f.numpy())), None))
    monkeypatch.setattr(jrunner, "trimap_eval_step", lambda v, bank, f, *a, **kw: (
        bank, _fake_trimap(np.asarray(f))))
    monkeypatch.setattr(runner, "trimap_eval_step", lambda stm, bank, f, *a, **kw: (
        bank, torch.from_numpy(_fake_trimap(f.numpy()))))

    fba = init_models(0, stage=2, scale=SCALE)[1].state_dict()
    ev = StreamingEvaluator(None, fba, EvalProtocol(stage=2, scale=SCALE), device="cpu")
    jev = jrunner.StreamingEvaluator(None, None, jrunner.EvalProtocol(stage=2))
    for side, e in (("port", ev), ("jax", jev)):
        e.run_video(vid["frames"], vid["first_trimap"], out_dir=str(tmp_path / side / "pred"),
                    filenames=vid["filenames"], viz_dir=str(tmp_path / side / "viz"),
                    gt_trimaps=gts)
    stm = STM(hdim=-1, scale=SCALE).state_dict()
    TrimapEvaluator(stm, EvalProtocol(scale=SCALE), device="cpu").run_video(
        vid["frames"], vid["first_trimap"], out_dir=str(tmp_path / "port" / "tri"),
        filenames=vid["filenames"])
    jrunner.TrimapEvaluator({}, jrunner.EvalProtocol()).run_video(
        vid["frames"], vid["first_trimap"], out_dir=str(tmp_path / "jax" / "tri"),
        filenames=vid["filenames"])
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    assert len([k for k in got if k.startswith("pred")]) == N
    assert len([k for k in got if k.startswith("tri")]) == N
    assert len([k for k in got if k.endswith(".jpg")]) == N
    for k in want:
        assert got[k] == want[k], k
    png = cv2.imread(str(tmp_path / "port" / "pred" / "00003.png"), cv2.IMREAD_UNCHANGED)
    a = _fake_alpha(np.rint(vid["frames"][3] * 255).astype(np.uint8)[None])[0, ..., 0]
    np.testing.assert_array_equal(png, (np.clip(a, 0, 1) * 255).astype(np.uint8))   # truncated


@pytest.fixture(scope="module")
def joint():
    stm_vars, fba_vars = jax_joint_variables(4, SCALE, H, W, seed=5)
    return stm_vars, fba_vars, from_jax(stm_vars, fba_vars, stage=4, scale=SCALE)


def _close(got, want):
    assert got["videos"] == want["videos"] == 2
    keys = [k for k in want if k not in ("fps", "videos")]
    assert sorted(keys) == sorted(k for k in got if k not in ("fps", "videos"))
    for k in keys:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, err_msg=k)


def test_evaluate_vm108_matches_jax_at_every_width(roots, joint, tmp_path):
    vm, _ = roots
    stm_vars, fba_vars, (stm_sd, fba_sd) = joint
    scores = {}
    for width in ("narrow", "medium", "wide"):
        ev = StreamingEvaluator(stm_sd, fba_sd, EvalProtocol(trimap_width=width, scale=SCALE,
                                                             **PROTO), device="cpu")
        jev = jrunner.StreamingEvaluator(stm_vars, fba_vars, jrunner.EvalProtocol(
            trimap_width=width, scale=SCALE, **PROTO))
        out = str(tmp_path / width) if width == "medium" else None
        scores[width] = evaluate_vm108(ev, vm, out_dir=out)
        _close(scores[width], jrunner.evaluate_vm108(jev, vm))
    assert len({scores[w]["SAD"] for w in scores}) == 3       # the width reaches the mask
    assert sorted(os.listdir(tmp_path / "medium")) == ["clipA", "clipB"]
    assert len(os.listdir(tmp_path / "medium" / "clipB")) == N
    with pytest.raises(ValueError, match="trimap_width"):
        EvalProtocol(trimap_width="thin")


def test_evaluate_vm108_trimap_matches_jax(roots):
    vm, _ = roots
    stm_vars = jax_joint_variables(1, 1, H, W, seed=40)[0]
    tev = TrimapEvaluator(stm_from_jax(stm_vars, hdim=-1), EvalProtocol(**PROTO), device="cpu")
    got = evaluate_vm108_trimap(tev, vm, max_videos=2)
    want = jrunner.evaluate_vm108_trimap(jrunner.TrimapEvaluator(
        stm_vars, jrunner.EvalProtocol(**PROTO)), vm, max_videos=2)
    assert got["videos"] == want["videos"] == 2
    assert 0.0 < got["iou"] <= 1.0
    np.testing.assert_allclose(got["iou"], want["iou"], rtol=METRIC_RTOL)


def _scaled_cfg():
    cfg = get_cfg_defaults()
    cfg.model_scale = SCALE
    return cfg


def test_cli_main_on_the_cpu(roots, tmp_path, monkeypatch, capsys):
    vm, demo = roots
    monkeypatch.setattr(cli_eval, "get_cfg_defaults", _scaled_cfg)
    monkeypatch.chdir(tmp_path)
    base = ["--device", "cpu"]
    res = cli_eval.main(base + ["--data-root", vm, "--outdir", "s1"])
    printed = json.loads(capsys.readouterr().out.split("random weights\n")[-1])
    assert printed == res and res["videos"] == 2
    assert all(np.isfinite(res[k]) for k in ("SAD", "MSE", "Grad", "Conn", "SSDA", "dtSSD",
                                              "MESSDdt"))
    cli_eval.main(base + ["--data-root", vm, "--outdir", "s2", "--streams", "2"])
    one, two = _files(tmp_path / "s1"), _files(tmp_path / "s2")
    assert len(one) == 2 * N and one == two
    assert sorted(os.listdir(tmp_path / "s1" / "pred")) == ["clipA", "clipB"]

    cli_eval.main(base + ["--demo", "--data-root", demo, "--viz", "--testmode"])
    out = tmp_path / "demo_results"
    assert sorted(os.listdir(out / "pred" / "clipB")) == [f"{i:05d}.png" for i in range(4)]
    assert len(os.listdir(out / "viz" / "clipA")) >= 4
    res = cli_eval.main(base + ["--trimap-net", "--data-root", vm, "--trimap", "wide"])
    assert res["videos"] == 2 and 0.0 < res["iou"] <= 1.0
    tri_dir = tmp_path / "train_log" / "alpha" / "test" / "wide" / "s1_OTVM_trimap" / "pred_trimap"
    assert len(os.listdir(tri_dir / "clipA")) == N
    res = cli_eval.main(base + ["--stage", "2", "--data-root", vm, "--outdir", "g"])
    assert res["videos"] == 2 and len(os.listdir(tmp_path / "g" / "pred" / "clipA")) == N
    with pytest.raises(SystemExit):
        cli_eval.main(base + ["--stage", "2", "--streams", "2", "--data-root", vm])
