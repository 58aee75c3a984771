"""Stage-1 trimap (STM) training from the command line, the port's
train_s1_trimap.py: the STM alone, trained on the CE of its propagated
trimaps over DIM clips, optionally from STM_weights.pth.

    python -m otvm_tpu_torch.cli.train_s1_trimap [--data-root PATH] [--testmode]
        [--init STM_weights.pth] [--resume FILE] [--max-iters N] [--device cuda|cpu]

The JAX CLI's flags, names and defaults, and `--device` (default cuda).
Each epoch saves weights/s1_OTVM_trimap under the working directory; the
log line carries the reference's in-training IoU (eval/metrics.py
reference_iou) of the propagated frames (1 and on) of the logged batch.
One process on one device, as cli/train.py.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

from .. import resolve_device
from ..config import get_cfg_defaults
from ..convert import load_pth
from ..data.datasets import DIMTrain
from ..data.loader import Loader, encode_wire, epoch_indices
from ..eval.metrics import reference_iou
from ..train.trainer import init_train_state, make_trimap_s1_train_step
from ..utils.checkpoint import save_train_state
from ..utils.logging import AverageMeter, create_logger
from .train import apply_overrides, resume, single_process

MODEL_NAME = "s1_OTVM_trimap"


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train OTVM stage-1 trimap (PyTorch port)")
    p.add_argument("--data-root", type=str, default=None)
    p.add_argument("--testmode", action="store_true")
    p.add_argument("--init", type=str, default=None,
                   help="STM_weights.pth (module.-prefixed)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--repeats", type=int, default=20)
    p.add_argument("--input-size", type=int, default=None,
                   help="square train crop override (default 320)")
    p.add_argument("--workers", type=int, default=None,
                   help="loader threads (cfg.system.num_workers, default 8)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 network compute, fp32 master params/optimizer")
    p.add_argument("--lr", type=float, default=None,
                   help="base LR override (default 1e-5)")
    p.add_argument("--stm-gn", action="store_true",
                   help="GroupNorm STM trunk (from-scratch recipe; frozen BN "
                        "at random init is the identity and does not train)")
    p.add_argument("--resume", type=str, default=None,
                   help="a port train-state checkpoint (networks, optimizer, step)")
    p.add_argument("--max-iters", type=int, default=None,
                   help="hard cap on iterations per epoch (LR probes)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs on the CPU)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Trains; returns {'state', 'losses', 'ious' (the logged values),
    'start_epoch', 'run_dir'}."""
    args = parse_args(argv)
    if args.init and not args.init.endswith(".pth"):
        # the JAX CLI reads only a .pth here, and passes over any other path
        raise ValueError(f"--init {args.init}: takes a released .pth (STM_weights.pth)")
    single_process()
    device = resolve_device(args.device)
    cfg = get_cfg_defaults()
    cfg.train.stage = 1
    apply_overrides(cfg, args)
    logger, run_dir = create_logger(cfg.system.outdir, MODEL_NAME)

    dataset = DIMTrain.from_adobe_layout(cfg.dataset.path, image_shape=cfg.train.train_input_size,
                                         sample_length=cfg.train.frame_num)
    iters_per_epoch = max(len(dataset) * args.repeats // cfg.train.batch_size, 1)
    state = init_train_state(cfg, cfg.system.random_seed, iters_per_epoch, device=device)
    if args.init:
        state.stm.load_state_dict(load_pth(args.init)[0], strict=True)
    start_epoch = resume(args.resume, state, iters_per_epoch, cfg.train.total_epochs, logger)

    train_step = make_trimap_s1_train_step(cfg)
    meter, iou_meter = AverageMeter(), AverageMeter()
    losses, ious = [], []
    total_epochs = 1 if cfg.system.testmode else cfg.train.total_epochs
    for epoch in range(start_epoch, total_epochs):
        idx = epoch_indices(len(dataset), epoch, args.repeats, cfg.system.random_seed)
        loader = Loader(dataset, idx, cfg.train.batch_size, seed=cfg.system.random_seed + epoch,
                        num_threads=cfg.system.num_workers)
        # the loss stays on the device between log lines (one sync per 50 steps)
        loss_acc, n_acc = None, 0
        for i, sample in enumerate(loader):
            if cfg.system.testmode and i > 20:
                break
            if args.max_iters and i >= args.max_iters:
                break
            batch = encode_wire({k: sample[k] for k in ("fg", "bg", "alpha", "tri")})
            state, metrics = train_step(state, batch)
            loss_acc = metrics["loss"] if loss_acc is None else loss_acc + metrics["loss"]
            n_acc += 1
            if i % 50 == 0:
                meter.update(float(loss_acc) / n_acc, n_acc)
                losses.append(meter.val)
                loss_acc, n_acc = None, 0
                # frame 0 is the GT trimap: only the propagated frames score
                # (train_s1_trimap.py:287-303)
                iou_meter.update(reference_iou(metrics["pred_lab"][:, 1:].cpu().numpy(),
                                               metrics["gt_lab"][:, 1:].cpu().numpy()))
                ious.append(iou_meter.val)
                logger.info(f"E{epoch} I{i} CE {meter.val:.4f} ({meter.avg:.4f}) "
                            f"IoU {iou_meter.val:.2f} ({iou_meter.avg:.2f})")
        save_train_state(os.path.join("weights", MODEL_NAME), state)
    return dict(state=state, losses=losses, ious=ious, start_epoch=start_epoch, run_dir=run_dir)


if __name__ == "__main__":
    main()
