"""Streaming evaluation from the command line, the port's eval.py.

    python -m otvm_tpu_torch.cli.eval --demo [--data-root ./demo] --weights s4_OTVM.pth
    python -m otvm_tpu_torch.cli.eval --trimap medium --data-root <root of VideoMatting108> \
        --weights weights/s4_OTVM
    python -m otvm_tpu_torch.cli.eval --trimap-net --weights weights/s1_OTVM_trimap ...

The JAX CLI's flags, names and defaults, and `--device` (default cuda;
`--device cpu` runs on the CPU).  Weights: a released .pth
(convert.load_pth) or the port's own train-state file
(utils/checkpoint.save_train_state); not an orbax directory.  Without
--weights the networks take random weights.  One process on one device.
Outputs go under the working directory unless --outdir says otherwise
(./demo_results, or <cfg.system.outdir>/alpha/test/<width>/<model>).
On CUDA every evaluator replays each frame's step from CUDA graphs
(models/graphs.py); --eager runs it eagerly, a check mode whose every read
a lockstep check (tools/kernel_check.py) can see.
"""
from __future__ import annotations

import argparse
import json
import os
import types
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import MODEL_NAMES, get_cfg_defaults
from ..convert import load_pth
from ..eval.runner import (EvalProtocol, MultiStreamEvaluator, StreamingEvaluator,
                           TrimapEvaluator, _has_running_stats, evaluate_vm108,
                           evaluate_vm108_trimap, iter_demo_videos)
from ..models.otvm import init_models
from ..utils.checkpoint import restore_params_only

StateDict = Mapping[str, torch.Tensor]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Evaluate OTVM (PyTorch port)")
    p.add_argument("--trimap", default="medium", choices=["narrow", "medium", "wide"])
    p.add_argument("--stage", type=int, default=4, choices=[1, 2, 3, 4],
                   help="checkpoint stage: 1/2 = alpha with GIVEN trimaps "
                        "(no trimap net), 3/4 = joint streaming")
    p.add_argument("--trimap-net", action="store_true",
                   help="evaluate trimap propagation only "
                        "(s1_OTVM_trimap checkpoints); reports IoU on VM108")
    p.add_argument("--demo", action="store_true")
    p.add_argument("--viz", action="store_true")
    p.add_argument("--data-root", type=str, default=None)
    p.add_argument("--weights", type=str, default=None,
                   help="a released .pth or a train-state file of the port's trainer")
    p.add_argument("--outdir", type=str, default=None)
    p.add_argument("--max-videos", type=int, default=None)
    p.add_argument("--testmode", action="store_true")
    p.add_argument("--max-edge", type=int, default=None,
                   help="downscale frames so min(H,W) <= this (testmode: 256)")
    p.add_argument("--arch", default="resnet50_GN_WS",
                   choices=["resnet50_GN_WS", "resnet50_BN"],
                   help="FBA trunk the checkpoint was trained with "
                        "(Config.alpha.arch); must match for param restore")
    p.add_argument("--streams", type=int, default=1,
                   help="serve N videos at once on one card (round-robin "
                        "B=1 steps, one memory bank per stream; joint stages "
                        "3/4 only).  Per-video outputs are those of --streams 1")
    p.add_argument("--wire-u8", action="store_true",
                   help="alpha and trimap as uint8 made on the device before "
                        "each frame's copy to the host (joint stages 3/4; "
                        "rounds, where the PNGs truncate)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs on the CPU)")
    p.add_argument("--eager", action="store_true",
                   help="check mode: run each frame's step eagerly instead of replaying "
                        "its CUDA graph, so that a lockstep check of the reads sees every "
                        "one (the CPU always runs eagerly)")
    return p.parse_args(argv)


def load_weights(path: Optional[str], stage: int = 4, arch: str = "resnet50_GN_WS"
                 ) -> Tuple[StateDict, StateDict]:
    """The (STM, FBA) state_dicts to serve at `stage`: from a released .pth
    (convert.load_pth), from the port's train-state file (the networks of
    save_train_state, restored over a fresh stage template as
    restore_params_only does: keys the file lacks keep the random init),
    or random weights (seed 0) without a path.  An STM state without BN
    running statistics selects the GroupNorm trunk (the from-scratch
    recipe), as the JAX CLI's has_batch_stats probe does."""
    cfg = get_cfg_defaults()
    if path is not None and path.endswith(".pth"):
        return load_pth(path)
    stm_norm = cfg.stm_norm
    if path is not None:
        if os.path.isdir(path):
            raise ValueError(f"{path} is a directory (an orbax checkpoint of the JAX "
                             "package?): the port reads released .pth files and its own "
                             "train-state files (utils/checkpoint.py)")
        saved = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        if not _has_running_stats(saved["stm"]):
            print("[eval] checkpoint has no BN running stats -> serving the GN-trunk STM "
                  "(stm_norm=gn); if this checkpoint was BN-trained, its stats are missing "
                  "and results will be wrong")
            stm_norm = "gn"
    stm, fba = init_models(0, stage, cfg.model_scale, stm_norm, arch)
    if path is None:
        print("WARNING: no --weights given; using random weights")
    else:
        restore_params_only(path, types.SimpleNamespace(stm=stm, fba=fba))
    return stm.state_dict(), fba.state_dict()


def _downscale(max_edge: Optional[int], frames, tri):
    """Frames resized so min(H, W) <= max_edge, the trimap by its labels."""
    if max_edge is None:
        return frames, tri
    import cv2

    h, w = frames[0].shape[:2]
    s = max_edge / min(h, w)
    if s >= 1:
        return frames, tri
    size = (int(w * s), int(h * s))
    frames = [cv2.resize(f, size) for f in frames]
    lbl = cv2.resize(tri.argmax(-1).astype("uint8"), size, interpolation=cv2.INTER_NEAREST)
    return frames, np.eye(3, dtype=np.float32)[lbl]


def main(argv: Optional[Sequence[str]] = None) -> Optional[Dict]:
    """Runs the evaluation; returns the printed VM108 results (None for
    --demo)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_cfg_defaults()
    data_root = args.data_root or ("./demo" if args.demo else cfg.dataset.path)
    model_name = "s1_OTVM_trimap" if args.trimap_net else MODEL_NAMES[args.stage]
    outdir = args.outdir or ("./demo_results" if args.demo else
                             os.path.join(cfg.system.outdir, "alpha", "test", args.trimap,
                                          model_name))
    if args.streams > 1 and (args.trimap_net or args.stage <= 2):
        raise SystemExit("--streams > 1 is the joint serving path (stages 3/4, not "
                         "--trimap-net)")

    graphs = False if args.eager else None
    trimap_sd, alpha_sd = load_weights(args.weights, stage=(1 if args.trimap_net else args.stage),
                                       arch=args.arch)
    protocol = EvalProtocol(memory_max_num=cfg.test.memory_max_num,
                            memory_skip_frame=cfg.test.memory_skip_frame,
                            trimap_width=args.trimap, stage=args.stage, arch=args.arch,
                            wire_u8_out=args.wire_u8, scale=cfg.model_scale)
    if args.trimap_net:
        tev = TrimapEvaluator(trimap_sd, protocol, device=device, graphs=graphs)
        if args.demo:
            for vid in iter_demo_videos(data_root):
                frames = vid["frames"][:4] if args.testmode else vid["frames"]
                trimaps, fps = tev.run_video(
                    frames, vid["first_trimap"],
                    out_dir=os.path.join(outdir, "pred_trimap", vid["seq_name"]),
                    filenames=vid["filenames"])
                print(f"{vid['seq_name']}: {len(trimaps)} trimaps @ {fps:.2f} fps")
            return None
        results = evaluate_vm108_trimap(tev, data_root, out_dir=os.path.join(outdir, "pred_trimap"),
                                        max_videos=(2 if args.testmode else args.max_videos))
        print(json.dumps(results, indent=2))
        return results

    evaluator = MultiStreamEvaluator if args.streams > 1 else StreamingEvaluator
    ev = evaluator(trimap_sd, alpha_sd, protocol, device=device, graphs=graphs)
    max_edge = args.max_edge or (256 if args.testmode else None)
    if not args.demo:
        results = evaluate_vm108(ev, data_root, out_dir=os.path.join(outdir, "pred"),
                                 max_videos=(2 if args.testmode else args.max_videos),
                                 streams=args.streams)
        print(json.dumps(results, indent=2))
        return results

    def demo_videos():
        for vid in iter_demo_videos(data_root):
            frames = vid["frames"][:4] if args.testmode else vid["frames"]
            vid["frames"], vid["first_trimap"] = _downscale(max_edge, frames, vid["first_trimap"])
            yield vid

    if args.streams > 1:
        vids = list(demo_videos())
        for i in range(0, len(vids), args.streams):
            group = vids[i:i + args.streams]
            results, agg_fps = ev.run_videos(
                group, out_root=os.path.join(outdir, "pred"),
                viz_root=os.path.join(outdir, "viz") if args.viz else None)
            names = ", ".join(v["seq_name"] for v in group)
            n = sum(len(a) for a, _ in results)
            print(f"[{names}]: {n} frames @ {agg_fps:.2f} fps aggregate")
    else:
        for vid in demo_videos():
            alphas, _, fps = ev.run_video(
                vid["frames"], vid["first_trimap"],
                out_dir=os.path.join(outdir, "pred", vid["seq_name"]),
                filenames=vid["filenames"],
                viz_dir=os.path.join(outdir, "viz", vid["seq_name"]) if args.viz else None)
            print(f"{vid['seq_name']}: {len(alphas)} frames @ {fps:.2f} fps")
    return None


if __name__ == "__main__":
    main()
