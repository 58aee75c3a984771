"""The port's quality tool (otvm_tpu_torch/tools/quality_check.py) and its
training chain (tools/train_chain.py) against the JAX package's, on the CPU.

  * trained and onsynth: the port's sections against the JAX package's
    composition of the same steps, on the same scale-4 weights (the
    port's random init on the GN STM trunk, carried by convert.to_jax) and
    a 4-frame 64x80 val clip written from a numpy seed: JAX's
    evaluate_vm108 through its StreamingEvaluator, and
    scripts/quality_check.py's _stream (eval_frame_step, make_eval_bank,
    _pad_frame, _unpad, with the model's scale, which the script's own
    _stream does not take) scored by JAX's video_metrics.  SAD and MSE
    within 1e-4 relative (fp32 summation order moves them ~1e-6), the other
    metrics within 1e-3 (tests/test_torch_eval_cli.py's bound); the
    streams' alphas as tests/test_torch_stream.py holds them: at most 1%
    of values off by more than 1e-3 (near-tied trimap argmaxes of random
    weights).
  * dim_overfit: against the JAX script's loop around otvm_tpu's
    alpha_predict (full width, stage 1: JAX's takes no scale) on two DIM
    images of 56x72 (padded to 64x96: both scripts stack the images, so
    they share a size), the trimap given; SAD and MSE within 1e-4
    relative.
  * The gate: the port's verdict equals scripts/s1t_gate.py's on written
    logs (pass, fail, too few points).
  * The chain (no stage run: the CLIs' main and the sections stubbed):
    each stage's argv is train_chain_r4.sh's, .done markers skip stages,
    an unfinished stage resumes from its checkpoint, a failed gate stops
    the chain, and so does a resume whose first loss or replay parts from
    the checkpoint's eager steps; the CLIs' clock of their wait on the
    Loader.
"""
import importlib.util
import json
import os
import re
import types

import cv2
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from otvm_tpu.eval import runner as jrunner  # noqa: E402
from otvm_tpu.eval.metrics import video_metrics as jax_video_metrics  # noqa: E402
from otvm_tpu.models.otvm import alpha_predict as jax_alpha_predict  # noqa: E402
from otvm_tpu.models.otvm import eval_frame_step as jax_eval_frame_step  # noqa: E402
from otvm_tpu.models.otvm import make_eval_bank as jax_make_eval_bank  # noqa: E402
from otvm_tpu.nn.ops import pad_divide_by  # noqa: E402
from otvm_tpu_torch.convert import to_jax  # noqa: E402
from otvm_tpu_torch.data.trimap import trimap_from_alpha  # noqa: E402
from otvm_tpu_torch.models.otvm import init_models  # noqa: E402
from otvm_tpu_torch.tools import quality_check as Q  # noqa: E402
from otvm_tpu_torch.tools import train_chain as C  # noqa: E402
from tests.torch_port import one_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, N, SCALE = 64, 80, 4, 4
SAD_MSE_RTOL = 1e-4
METRIC_RTOL = 1e-3


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """make_synth_data.py's layout: one val clip of N frames at H x W
    (VideoMatting108/) and two DIM images with their backgrounds
    (Combined_Dataset/), from a numpy seed."""
    root = tmp_path_factory.mktemp("synth")
    rng = np.random.RandomState(3)
    smooth = lambda h, w: cv2.resize(rng.randint(0, 255, (6, 7, 3)).astype(np.uint8), (w, h))

    def alpha(h, w, shift):
        yy, xx = np.mgrid[:h, :w]
        d = np.hypot(yy - h / 2, xx - w / 2 - shift)
        return (np.clip((h / 4 - d) / 5 + 0.5, 0, 1) * 255).astype(np.uint8)

    vm = root / "VideoMatting108"
    corr = {}
    for d in ("FG_done", "BG_done2"):
        (vm / d / "clip0").mkdir(parents=True)
    for i in range(N):
        fn = f"clip0/{i:05d}.png"
        cv2.imwrite(str(vm / "FG_done" / fn), np.dstack([smooth(H, W), alpha(H, W, 2 * i)]))
        cv2.imwrite(str(vm / "BG_done2" / fn), smooth(H, W))
        corr[fn] = fn
    (vm / "frame_corr.json").write_text(json.dumps(corr))
    (vm / "val_videos.txt").write_text("clip0\n")
    base = root / "Combined_Dataset" / "Training_set"
    fg, al, bg = (base / "Adobe-licensed images" / "fg", base / "Adobe-licensed images" / "alpha",
                  base / "train2014")
    for d in (fg, al, bg):
        d.mkdir(parents=True)
    for i, (h, w) in enumerate(((56, 72), (56, 72))):
        cv2.imwrite(str(fg / f"fg{i}.png"), smooth(h, w))
        cv2.imwrite(str(al / f"fg{i}.png"), alpha(h, w, 3 * i))
        cv2.imwrite(str(bg / f"bg{i}.jpg"), smooth(48, 48))
    return str(root)


@pytest.fixture(scope="module")
def joint():
    """Scale-4 stage-4 weights on the GN STM trunk: the port's state_dicts
    and JAX's variables."""
    stm, fba = init_models(5, 4, SCALE, "gn")
    stm_sd, fba_sd = stm.state_dict(), fba.state_dict()
    return stm_sd, fba_sd, to_jax(stm_sd, fba_sd, 4, SCALE)


def _close(got, want, keys):
    for k in keys:
        assert np.isfinite(got[k]), k
        rtol = SAD_MSE_RTOL if k in ("SAD", "MSE") else METRIC_RTOL
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


def test_trained_matches_jax(synth, joint):
    stm_sd, fba_sd, (stm_vars, fba_vars) = joint
    got = Q.trained(stm_sd, fba_sd, synth, "t", scale=SCALE, device="cpu")
    assert list(got) == ["trained_vm108_synth_t"]
    got = got["trained_vm108_synth_t"]
    want = jrunner.evaluate_vm108(jrunner.StreamingEvaluator(
        stm_vars, fba_vars, jrunner.EvalProtocol(scale=SCALE)), synth, mode="val")
    assert got["videos"] == want["videos"] == 1
    _close(got, want, ("SAD", "MSE", "Grad", "Conn", "SSDA", "dtSSD", "MESSDdt"))


def _jax_stream(stm_vars, fba_vars, frames, tri, exact_edt=False):
    """scripts/quality_check.py _stream, fp32, with the model's scale."""
    proto = jrunner.EvalProtocol()
    flags, max_num, _ = proto.flags(len(frames), *frames[0].shape[:2])
    f0, t0, pad0 = jrunner._pad_frame(frames[0], tri)
    bank = jax_make_eval_bank(1, f0.shape[0], f0.shape[1], max_num, np.float32, scale=SCALE)
    first_tri = jnp.asarray(t0[None], jnp.float32)
    alphas = []
    for i in range(len(frames)):
        f, _, pad = jrunner._pad_frame(frames[i], None) if i else (f0, t0, pad0)
        first, memorize, last = flags[i]
        out = jax_eval_frame_step(
            stm_vars, fba_vars, bank, jnp.asarray(f[None], jnp.float32), first_tri,
            jnp.asarray(first), jnp.asarray(memorize), jnp.asarray(last), stage=4,
            max_memory_num=max_num, exact_edt=exact_edt, scale=SCALE, stm_norm="gn")
        bank = out.bank
        alphas.append(jrunner._unpad(np.asarray(out.alpha[0, :, :, 0], np.float32), pad))
    return np.stack(alphas)


def test_onsynth_matches_jax(synth, joint):
    stm_sd, fba_sd, (stm_vars, fba_vars) = joint
    got = Q.onsynth(stm_sd, fba_sd, synth, max_frames=N, scale=SCALE,
                    device="cpu")["onsynth_variants"]
    vid = next(jrunner.iter_vm108_videos(synth, "val", 12))
    frames, tri = vid["frames"], vid["first_trimap"]
    gt = np.stack(vid["gt_alpha"]) * 255.0
    mask = np.stack([trimap_from_alpha(a, 12)[..., 1] for a in vid["gt_alpha"]]) * 128.0
    assert got["frames"] == N and set(got["sad"]) == {"jfa_fp32", "exact_fp32", "jfa_bf16"}
    for name, exact in (("jfa_fp32", False), ("exact_fp32", True)):
        want_alphas = _jax_stream(stm_vars, fba_vars, frames, tri, exact)
        want = jax_video_metrics(want_alphas * 255.0, gt, mask)
        _close(dict(SAD=got["sad"][name], MSE=got["mse"][name]), want, ("SAD", "MSE"))
        alphas = np.stack(Q.stream(stm_sd, fba_sd, frames, tri, exact, scale=SCALE,
                                   device="cpu"))
        np.testing.assert_allclose(alphas[0], want_alphas[0], atol=1e-3)
        assert (np.abs(alphas - want_alphas) > 1e-3).mean() <= 0.01, name
    assert np.isfinite(got["sad"]["jfa_bf16"]) and got["bf16_alpha_delta"]["mean"] > 0
    assert got["edt_sad_rel_diff_pct"] == pytest.approx(
        abs(got["sad"]["exact_fp32"] - got["sad"]["jfa_fp32"]) / got["sad"]["jfa_fp32"] * 100)


def test_dim_overfit_matches_jax(synth):
    fba = init_models(6, 1)[1].state_dict()
    got = Q.dim_overfit(fba, synth, "d", device="cpu")["dim_overfit_d"]
    fba_vars = to_jax(init_models(6, 1)[0].state_dict(), fba, 1)[1]
    preds, gts, masks = [], [], []
    for comp, a in Q.dim_images(synth):          # the JAX script's loop, :359-374
        tri = trimap_from_alpha(a, 12)
        f_p, _ = pad_divide_by(jnp.asarray(comp[None], jnp.float32), 32)
        t_p, _ = pad_divide_by(jnp.asarray(tri[None], jnp.float32), 32)
        alpha, _ = jax_alpha_predict(fba_vars, f_p, t_p, stage=1)
        h, w = comp.shape[:2]
        ph, pw = (f_p.shape[1] - h) // 2, (f_p.shape[2] - w) // 2
        preds.append(np.asarray(alpha[0, ph:ph + h, pw:pw + w, 0]))
        gts.append(a)
        masks.append(tri[..., 1])
    assert [p.shape for p in preds] == [(56, 72)] * 2 and got["images"] == 2
    want = jax_video_metrics(np.stack(preds) * 255.0, np.stack(gts) * 255.0,
                             np.stack(masks) * 128.0)
    _close(got, want, ("SAD", "MSE"))


def _write_log(run_dir, ious):
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "s1_OTVM_trimap_2026-01-01-00-00_train.log"), "w") as f:
        for n, iou in enumerate(ious):
            f.write(f"2026-01-01 00:00:00,000 E{n // 4} I{50 * (n % 4)} CE 0.6500 (0.6600) "
                    f"IoU {iou:.2f} ({iou:.2f})\n")


@pytest.mark.parametrize("ious, verdict, code", [
    ([25.0, 26.0, 30.0, 33.0, 38.0, 41.0, 44.0, 47.0, 49.0, 52.0], "pass", None),
    ([25.0, 26.0, 27.0, 26.0, 28.0, 27.0, 28.0, 29.0, 27.0, 28.0], "fail", 1),
    ([25.0, 60.0, 61.0], "too few", 2)])
def test_gate_gives_the_scripts_verdict(tmp_path, monkeypatch, ious, verdict, code):
    run_dir = str(tmp_path / "s1_OTVM_trimap")
    _write_log(run_dir, ious)
    got = Q.gate(run_dir)["s1t_gate"]
    assert got["verdict"] == verdict and got["passed"] == (verdict == "pass")
    assert got["points"] == len(ious)
    script = _script("s1t_gate")
    assert [p[2] for p in script.parse_log(run_dir)] == [p[2] for p in Q.gate_points(run_dir)]
    monkeypatch.setattr("sys.argv", ["s1t_gate.py", run_dir])
    if code is None:
        script.main()
    else:
        with pytest.raises(SystemExit) as e:
            script.main()
        assert e.value.code == code


def _r4_argv(data):
    """train_chain_r4.sh's python command lines, its variables at their
    defaults (DATA as given), keyed by the weights each resumes."""
    text = open(os.path.join(REPO, "scripts", "train_chain_r4.sh")).read().replace("\\\n", " ")
    env = dict(DATA=data, SIZE="320", PREC="--bf16", B="2", W="2", E1T="3", E1="4", E2="2",
               E3="2", E4="8")
    out = {}
    for cmd in re.findall(r"python (?:train|train_s1_trimap)\.py ([^\n]*)", text):
        argv = re.sub(r"\$\{?(\w+)\}?", lambda m: env[m.group(1)], cmd).replace('"', "").split()
        out[argv[argv.index("--resume") + 1]] = argv
    return out


class _FakeCLIs:
    """The CLIs' main: records each argv, writes the stage's checkpoint."""

    def __init__(self):
        self.calls = []

    def __call__(self, cli):
        def main(argv):
            self.calls.append((cli, list(argv)))
            weights = argv[argv.index("--resume") + 1]
            os.makedirs(os.path.dirname(weights), exist_ok=True)
            open(weights, "w").close()
            res = dict(state=types.SimpleNamespace(step=100), losses=[2.0, 1.0],
                       averages=[2.0, 1.5], steps=[1, 51], loader_wait_s=0.5, start_epoch=0)
            return dict(res, ious=[20.0, 40.0]) if cli == "train_s1_trimap" else res
        return main


def _stub_sections(monkeypatch, gate_passes=True):
    monkeypatch.setattr(Q, "random_baseline", lambda data, **kw: {
        "trained_vm108_synth_random": {"SAD": 20.0}, "dim_overfit_random": {"SAD": 18.0}})
    monkeypatch.setattr(Q, "gate", lambda run_dir, *a: {"s1t_gate": {
        "passed": gate_passes, "verdict": "pass" if gate_passes else "fail"}})
    monkeypatch.setattr(Q, "load_weights", lambda path, stage: ({}, {}))
    monkeypatch.setattr(Q, "dim_overfit", lambda fba, data, tag, **kw: {f"dim_overfit_{tag}": {}})
    monkeypatch.setattr(Q, "trained", lambda s, f, data, tag, **kw: {
        f"trained_vm108_synth_{tag}": {}})
    monkeypatch.setattr(Q, "onsynth", lambda s, f, data, tag, **kw: {
        f"onsynth_variants_{tag}": {}})


def test_the_chain_runs_r4s_stages_skips_done_ones_and_resumes(tmp_path, monkeypatch):
    fake = _FakeCLIs()
    monkeypatch.setattr(C, "cli_main", fake)
    monkeypatch.setattr(C, "resume_check", lambda stage, argv, device: dict(eager_loss=2.0))
    _stub_sections(monkeypatch)
    data = str(tmp_path / "data")
    root, args = str(tmp_path / "chain"), ["--data", data, "--device", "cpu"]
    report = C.main(["--root", root] + args)
    r4 = _r4_argv(data)
    assert [cli for cli, _ in fake.calls] == [s.cli for s in C.STAGES]
    for stage, (_, argv) in zip(C.STAGES, fake.calls):
        assert argv == r4[stage.weights] + ["--device", "cpu"], stage.name
    assert sorted(os.listdir(os.path.join(root, "train_log", "chain"))) == \
        sorted(f"{s.name}.done" for s in C.STAGES)
    assert {"trained_vm108_synth_random", "s1t_gate", "dim_overfit_post_s1",
            "trained_vm108_synth_pre_s4", "trained_vm108_synth_post_s4",
            "onsynth_variants_post_s4"} <= set(report)
    assert report["reduced"] == {} and all(not r[0]["resumed"] for r in report["stages"].values())

    fake.calls.clear()
    C.main(["--root", root] + args)                 # every stage done: none runs
    assert fake.calls == []

    os.remove(os.path.join(root, "train_log", "chain", "s4.done"))
    report = C.main(["--root", root, "--repeats", "5"] + args)
    assert [cli for cli, _ in fake.calls] == ["train"]
    argv = fake.calls[0][1]
    assert argv == r4["weights/s4_OTVM"] + ["--repeats", "5", "--device", "cpu"]
    last = report["stages"]["s4"][-1]
    assert last["resumed"] and last["resume_check"] == dict(first_logged_loss=2.0, eager_loss=2.0)
    assert last["failures"] == [] and last["loader_wait_ms_a_step"] == 5.0
    assert report["reduced"] == {"repeats": "5 (r4: 20)"}


def test_a_failed_gate_stops_the_chain(tmp_path, monkeypatch):
    fake = _FakeCLIs()
    monkeypatch.setattr(C, "cli_main", fake)
    _stub_sections(monkeypatch, gate_passes=False)
    root = str(tmp_path / "chain")
    with pytest.raises(SystemExit, match="gate"):
        C.main(["--root", root, "--data", str(tmp_path / "data"), "--device", "cpu"])
    assert [cli for cli, _ in fake.calls] == ["train_s1_trimap"]
    assert not os.path.exists(os.path.join(root, "train_log", "chain", "s1t.done"))


@pytest.mark.parametrize("tool", [Q, C])
def test_the_tools_need_cuda_unless_asked_for_cpu(tool, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = (["--synth", str(tmp_path), "--trained", "--out", str(tmp_path / "q.json")]
            if tool is Q else ["--root", str(tmp_path / "chain"), "--data", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)


def test_a_non_finite_loss_stops_a_run_at_its_first_step():
    import logging

    from otvm_tpu_torch.cli.train import stop_if_not_finite

    log = logging.getLogger("test_torch_quality")
    window = [torch.tensor(1.0), torch.tensor(float("nan")), torch.tensor(float("inf"))]
    stop_if_not_finite(1.5, window[:1], 0, 50, log)
    with pytest.raises(FloatingPointError, match=r"E2 I52: .* first non-finite step: E2 I51"):
        stop_if_not_finite(float("nan"), window, 2, 52, log)
    with pytest.raises(FloatingPointError, match="on another rank"):
        stop_if_not_finite(float("inf"), window[:1], 2, 50, log)


@pytest.mark.parametrize("check, why", [
    (dict(eager_loss=2.5), "the first logged loss 2.0 is not the eager step's"),
    (dict(eager_loss=2.0, replay=[2.0, 1.9, 1.8], failures=["loss of step 3: graphed differs"]),
     "loss of step 3: graphed differs"),
], ids=["first-loss", "replay"])
def test_a_resume_that_parts_from_its_checkpoint_stops_the_chain(check, why, tmp_path,
                                                                 monkeypatch):
    fake = _FakeCLIs()
    monkeypatch.setattr(C, "cli_main", fake)
    monkeypatch.setattr(C, "resume_check", lambda stage, argv, device: check)
    _stub_sections(monkeypatch)
    root = str(tmp_path / "chain")
    weights = os.path.join(root, C.STAGES[1].weights)       # stage 1 left a checkpoint
    os.makedirs(os.path.dirname(weights))
    open(weights, "w").close()
    with pytest.raises(RuntimeError, match=f"s1 resumed wrongly: .*{re.escape(why)}"):
        C.main(["--root", root, "--data", str(tmp_path / "data"), "--device", "cpu"])
    assert [cli for cli, _ in fake.calls] == ["train_s1_trimap", "train"]
    assert sorted(os.listdir(os.path.join(root, "train_log", "chain"))) == ["s1t.done"]
    with open(os.path.join(root, "chain_report.json")) as f:
        rec = json.load(f)["stages"]["s1"][-1]
    assert rec["resumed"] and why in rec["failures"][0]


def test_timed_batches_clocks_each_wait_and_closes_the_loader():
    from otvm_tpu_torch.cli.train import timed_batches

    closed = []

    def loader():
        try:
            yield from range(5)
        finally:
            closed.append(True)

    waits = []
    assert list(timed_batches(loader(), waits)) == list(range(5))
    assert len(waits) == 5 and all(w >= 0 for w in waits) and closed == [True]
    waits = []
    for i in timed_batches(loader(), waits):
        if i == 1:
            break
    assert len(waits) == 2 and closed == [True, True]
