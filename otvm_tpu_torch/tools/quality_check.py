"""What a checkpoint of the port has learned, scored on the synthetic
fixture (scripts/make_synth_data.py): the counterpart of the sections of
scripts/quality_check.py that need neither a reference checkout nor the
dove clip, a random-weight baseline of each, and the trimap-s1 learning
gate of scripts/s1t_gate.py.

    python -m otvm_tpu_torch.tools.quality_check --synth DIR [--out build/quality.json]
        [--trained] [--onsynth] [--weights weights/s4_OTVM]
        [--dim-overfit] [--dim-weights weights/s1_OTVM_alpha]
        [--random] [--gate train_log/s1_OTVM_trimap [--min-gain 5]]
        [--device cuda|cpu]

Sections, each a function of state_dicts and arrays that returns its
report entries (keys as the JAX script names them, `_<tag>` appended):
  * trained: evaluate_vm108 on the fixture's val clips through
    StreamingEvaluator (the 7 metrics, fps, videos);
  * onsynth: the first `max_frames` frames of the first val clip streamed
    three ways, the JFA fp32, the exact EDT fp32 and the JFA bf16, over
    float frames as the script's _stream feeds them (not the evaluators'
    uint8 wire): SAD and MSE of each, the relative SAD differences, the
    alpha deltas against the JFA fp32 stream;
  * dim_overfit: stage-1 alpha_predict on the fixture's DIM images, the
    trimap given (radius 12), padded to a multiple of 32 with zeros;
  * random: trained and dim_overfit on random weights (the training CLIs'
    seed, the GN STM trunk of the from-scratch recipe), tagged "random";
  * gate: the trimap-s1 log's in-training IoU, head against tail.
Weights go through cli/eval.py load_weights, which picks the GN STM trunk
for a checkpoint without BN running statistics.  The report is one JSON
file: an existing one is updated.  Runs on CUDA (the streams from CUDA
graphs; onsynth's graphs=False steps eagerly) unless --device cpu; a section that fails
raises, and a failed gate exits 1 (2 with too few log points).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..cli.eval import load_weights
from ..config import get_cfg_defaults
from ..data.trimap import trimap_from_alpha
from ..eval.metrics import video_metrics
from ..eval.runner import (EvalProtocol, StreamingEvaluator, _pad_frame, _unpad, evaluate_vm108,
                           iter_vm108_videos)
from ..models.otvm import alpha_predict, eval_frame_step, init_models, make_eval_bank, make_models
from ..nn.layers import freeze_for_inference
from ..nn.ops import divide_pad_amounts

StateDict = Mapping[str, torch.Tensor]
DIM_RADIUS = 12          # the dim_overfit trimap's unknown band, the medium width
RANDOM_SEED = get_cfg_defaults().system.random_seed     # the training CLIs' init
GATE_LINE = re.compile(r"E(\d+) I(\d+) CE ([\d.]+) \(([\d.]+)\) IoU ([\d.]+) \(([\d.]+)\)")


def _key(name: str, tag: str) -> str:
    return f"{name}_{tag}" if tag else name


def trained(trimap_sd: StateDict, alpha_sd: StateDict, synth_root: str, tag: str = "",
            scale: int = 1, device=None) -> Dict:
    """The VM108 protocol on the fixture's val clips (stage 4, medium
    trimaps): each metric's mean over clips, fps and videos."""
    ev = StreamingEvaluator(trimap_sd, alpha_sd, EvalProtocol(scale=scale), device=device)
    res = evaluate_vm108(ev, synth_root, mode="val")
    return {_key("trained_vm108_synth", tag): {k: float(v) for k, v in res.items()}}


def stream(trimap_sd: StateDict, alpha_sd: StateDict, frames01: Sequence[np.ndarray],
           first_trimap3: np.ndarray, exact_edt: bool = False, dtype: str = "fp32",
           scale: int = 1, device=None, graphs: Optional[bool] = None) -> List[np.ndarray]:
    """The script's _stream: eval_frame_step frame by frame over float
    frames in the serving dtype, the protocol's flags and bank; the
    alphas [H, W] fp32.  The step replays from CUDA graphs on CUDA unless
    graphs=False."""
    ev = StreamingEvaluator(trimap_sd, alpha_sd, EvalProtocol(dtype=dtype, scale=scale),
                            device=device, graphs=graphs)
    step = ev.step_graphs or (lambda *args, **kw: eval_frame_step(ev.stm, ev.fba, *args, **kw))
    flags, max_num, _ = ev.protocol.flags(len(frames01), *frames01[0].shape[:2])
    f0, t0, pad = _pad_frame(frames01[0], first_trimap3)
    bank = make_eval_bank(1, f0.shape[0], f0.shape[1], max_num, ev.dtype, scale, ev.device)
    first_tri = torch.from_numpy(t0[None]).to(ev.device, ev.dtype)
    alphas = []
    for i, (first, memorize, last) in enumerate(flags):
        f = f0 if i == 0 else _pad_frame(frames01[i], None)[0]
        out = step(bank, torch.from_numpy(f[None]).to(ev.device, ev.dtype), first_tri, first,
                   memorize, last, max_memory_num=max_num, exact_edt=exact_edt)
        bank = out.bank
        alphas.append(_unpad(out.alpha[0, ..., 0].float().cpu().numpy(), pad))
    return alphas


def onsynth(trimap_sd: StateDict, alpha_sd: StateDict, synth_root: str, tag: str = "",
            max_frames: int = 12, scale: int = 1, device=None,
            graphs: Optional[bool] = None) -> Dict:
    """The first val clip's first `max_frames` frames three ways (JFA fp32,
    exact EDT fp32, JFA bf16), scored on the GT alpha's unknown band
    (radius 12)."""
    vid = next(iter_vm108_videos(synth_root, "val", DIM_RADIUS))
    frames, tri = vid["frames"][:max_frames], vid["first_trimap"]
    gt_alpha = vid["gt_alpha"][:max_frames]
    gt = np.stack(gt_alpha) * 255.0
    mask = np.stack([trimap_from_alpha(a, DIM_RADIUS)[..., 1] for a in gt_alpha]) * 128.0
    run = lambda **kw: np.stack(stream(trimap_sd, alpha_sd, frames, tri, scale=scale,
                                       device=device, graphs=graphs, **kw))
    alphas = dict(jfa_fp32=run(), exact_fp32=run(exact_edt=True), jfa_bf16=run(dtype="bf16"))
    scores = {k: video_metrics(a * 255.0, gt, mask) for k, a in alphas.items()}
    base = scores["jfa_fp32"]["SAD"]
    rel = lambda k: abs(scores[k]["SAD"] - base) / max(base, 1e-9) * 100
    delta = lambda k: np.abs(alphas["jfa_fp32"] - alphas[k])
    return {_key("onsynth_variants", tag): dict(
        frames=len(frames),
        sad={k: float(s["SAD"]) for k, s in scores.items()},
        mse={k: float(s["MSE"]) for k, s in scores.items()},
        edt_sad_rel_diff_pct=float(rel("exact_fp32")),
        bf16_sad_rel_diff_pct=float(rel("jfa_bf16")),
        edt_alpha_delta=dict(max=float(delta("exact_fp32").max()),
                             mean=float(delta("exact_fp32").mean())),
        bf16_alpha_delta=dict(max=float(delta("jfa_bf16").max()),
                              mean=float(delta("jfa_bf16").mean())))}


def dim_images(synth_root: str) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(composite [H, W, 3] fp32, alpha [H, W] fp32) of each DIM foreground
    of the fixture, over background i mod the backgrounds, resized to it."""
    import cv2

    root = os.path.join(synth_root, "Combined_Dataset", "Training_set")
    fg_dir = os.path.join(root, "Adobe-licensed images", "fg")
    a_dir = os.path.join(root, "Adobe-licensed images", "alpha")
    bg_dir = os.path.join(root, "train2014")
    bgs = sorted(os.listdir(bg_dir))
    out = []
    for i, name in enumerate(sorted(os.listdir(fg_dir))):
        fg = cv2.imread(os.path.join(fg_dir, name))[..., ::-1] / 255.0
        a = cv2.imread(os.path.join(a_dir, name), cv2.IMREAD_GRAYSCALE) / 255.0
        bg = cv2.imread(os.path.join(bg_dir, bgs[i % len(bgs)]))[..., ::-1] / 255.0
        bg = cv2.resize(bg, (fg.shape[1], fg.shape[0]))
        comp = (fg * a[..., None] + bg * (1 - a[..., None])).astype(np.float32)
        out.append((comp, a.astype(np.float32)))
    return out


def _dim_predict(fba, comp: np.ndarray, tri: np.ndarray, device) -> np.ndarray:
    """alpha_predict on one image and its trimap, both padded to a multiple
    of 32 with zeros, the alpha cropped back."""
    h, w = comp.shape[:2]
    lw, uw, lh, uh = divide_pad_amounts(h, w, 32)
    pad = lambda x: torch.from_numpy(np.pad(x, ((lh, uh), (lw, uw), (0, 0)))[None]).to(device)
    alpha, _ = alpha_predict(fba, pad(comp), pad(tri))
    return alpha[0, lh:lh + h, lw:lw + w, 0].cpu().numpy()


def dim_overfit(alpha_sd: StateDict, synth_root: str, tag: str = "", scale: int = 1,
                device=None) -> Dict:
    """Stage-1 alpha on the fixture's DIM images with the trimap given:
    SAD and MSE over the images as one clip, and the mean over the images
    that have an unknown band of the mean |error| on it."""
    device = resolve_device(device)
    fba = make_models(1, scale)[1]
    fba.load_state_dict(alpha_sd, strict=True)
    fba = freeze_for_inference(fba.to(device).eval().requires_grad_(False))
    preds, gts, masks = [], [], []
    for comp, a in dim_images(synth_root):
        tri = trimap_from_alpha(a, DIM_RADIUS)
        preds.append(_dim_predict(fba, comp, tri, device))
        gts.append(a)
        masks.append(tri[..., 1])
    m = video_metrics(np.stack(preds) * 255.0, np.stack(gts) * 255.0, np.stack(masks) * 128.0)
    banded = [np.abs(p - g)[k > 0.5].mean() for p, g, k in zip(preds, gts, masks) if k.any()]
    return {_key("dim_overfit", tag): dict(
        images=len(preds), SAD=float(m["SAD"]), MSE=float(m["MSE"]),
        mean_abs_err_unknown=float(np.mean(banded)), images_with_unknown=len(banded))}


def random_weights(seed: int = RANDOM_SEED, scale: int = 1, stm_norm: str = "gn"
                   ) -> Tuple[StateDict, StateDict, StateDict]:
    """(stage-4 STM, stage-4 FBA, stage-1 FBA) state_dicts, random from
    `seed`, on the from-scratch recipe's GN STM trunk by default: with the
    training CLIs' seed, the stage-1 FBA is the one `--stage 1 --stm-gn`
    starts from."""
    stm, fba = init_models(seed, 4, scale, stm_norm)
    fba1 = init_models(seed, 1, scale, stm_norm)[1]
    return stm.state_dict(), fba.state_dict(), fba1.state_dict()


def random_baseline(synth_root: str, seed: int = RANDOM_SEED, scale: int = 1,
                    device=None) -> Dict:
    """trained and dim_overfit on random weights, tagged 'random'."""
    stm_sd, fba_sd, fba1_sd = random_weights(seed, scale)
    return {**trained(stm_sd, fba_sd, synth_root, "random", scale=scale, device=device),
            **dim_overfit(fba1_sd, synth_root, "random", scale=scale, device=device)}


def gate_points(run_dir: str) -> List[Tuple[int, int, float]]:
    """(epoch, iteration, batch IoU) of every log line of a trimap-s1 run
    (cli/train_s1_trimap.py's line), in the logs' order."""
    logs = sorted(glob.glob(os.path.join(run_dir, "*", "*_train.log")) +
                  glob.glob(os.path.join(run_dir, "*_train.log")))
    points = []
    for path in logs:
        with open(path) as f:
            for line in f:
                m = GATE_LINE.search(line)
                if m:
                    points.append((int(m.group(1)), int(m.group(2)), float(m.group(5))))
    return points


def gate(run_dir: str, min_gain: float = 5.0, tag: str = "") -> Dict:
    """The trimap-s1 learning gate: the mean IoU of the last fifth of the
    log points (at least 2) minus that of the first fifth must reach
    `min_gain`; fewer than 4 points is no verdict ('too few')."""
    ious = [p[2] for p in gate_points(run_dir)]
    out = dict(points=len(ious), min_gain=min_gain)
    if len(ious) < 4:
        out.update(verdict="too few", passed=False)
    else:
        k = max(2, len(ious) // 5)
        head, tail = sum(ious[:k]) / k, sum(ious[-k:]) / k
        out.update(head=head, tail=tail, gain=tail - head,
                   verdict="pass" if tail - head >= min_gain else "fail",
                   passed=tail - head >= min_gain)
    return {_key("s1t_gate", tag): out}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--synth", required=True, help="make_synth_data.py's root")
    p.add_argument("--out", default="build/quality.json")
    p.add_argument("--trained", action="store_true")
    p.add_argument("--onsynth", action="store_true")
    p.add_argument("--weights", default="weights/s4_OTVM",
                   help="the stage-3 or -4 checkpoint of --trained and --onsynth")
    p.add_argument("--dim-overfit", action="store_true")
    p.add_argument("--dim-weights", default="weights/s1_OTVM_alpha")
    p.add_argument("--random", action="store_true",
                   help="the random-weight baseline of --trained and --dim-overfit")
    p.add_argument("--gate", default=None, metavar="RUN_DIR",
                   help="the trimap-s1 run directory (train_log/s1_OTVM_trimap)")
    p.add_argument("--min-gain", type=float, default=5.0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Runs the asked sections, writes and returns the report; a gate
    that fails exits 1, one without a verdict 2, after the report is
    written."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    report = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            report = json.load(f)

    def add(entries: Dict) -> None:
        report.update(entries)
        print(json.dumps(entries, indent=2))
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)

    verdict = None
    if args.gate:
        entries = gate(args.gate, args.min_gain)
        add(entries)
        verdict = next(iter(entries.values()))["verdict"]
    if args.trained or args.onsynth:
        stm_sd, fba_sd = load_weights(args.weights, 4)
        if args.trained:
            add(trained(stm_sd, fba_sd, args.synth, device=device))
        if args.onsynth:
            add(onsynth(stm_sd, fba_sd, args.synth, device=device))
    if args.dim_overfit:
        add(dim_overfit(load_weights(args.dim_weights, 1)[1], args.synth, device=device))
    if args.random:
        add(random_baseline(args.synth, device=device))
    print(f"wrote {args.out}")
    if verdict in ("fail", "too few"):
        raise SystemExit(1 if verdict == "fail" else 2)
    return report


if __name__ == "__main__":
    main()
