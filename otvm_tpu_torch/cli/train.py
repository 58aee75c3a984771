"""Stage-wise training from the command line, the port's train.py.

    python -m otvm_tpu_torch.cli.train --stage {1,2,3,4} [--data-root PATH] [--testmode]
        [--init CKPT.pth|FILE] [--init-trimap CKPT.pth|FILE] [--resume FILE]
        [--epochs N] [--batch-size B] [--device cuda|cpu]

Stages (train.py:86-168 of the reference):
  1  the alpha net alone on DIM (GT trimaps every frame)
  2  alpha trained, trimap net frozen, on DIM
  3  trimap net trained, alpha frozen, on DIM
  4  both, on VideoMatting108, with the max_skip curriculum

The JAX CLI's flags, names and defaults, and `--device` (default cuda).
Checkpoints (utils/checkpoint.save_train_state files) go to
<cfg.system.outdir>/<model>/ckpt_e<N> and weights/<model> under the working
directory, every `--save-every` epochs and at the last; the run's logs and
config.yaml to <cfg.system.outdir>/<model>/.  --init chains a prior stage
(a released .pth, or a port checkpoint: its networks, a fresh optimizer),
--init-trimap the STM alone, --resume a run (networks, optimizer, step).
One process on one device: data parallelism (ROADMAP.md §1 item 5) is not
ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict, Optional, Sequence

from .. import resolve_device
from ..config import Config, get_cfg_defaults, get_model_name
from ..convert import load_pth
from ..data.datasets import DIMTrain, VM108Train, vm108_max_skip_for_epoch
from ..data.loader import Loader, encode_wire, epoch_indices
from ..train.trainer import init_train_state, make_train_step, make_viz_forward
from ..utils.checkpoint import restore_params_only, restore_train_state, save_train_state
from ..utils.logging import AverageMeter, StepTimer, create_logger
from ..utils.viz import save_train_grid


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train OTVM (PyTorch port)")
    p.add_argument("--stage", type=int, required=True, choices=[1, 2, 3, 4])
    p.add_argument("--data-root", type=str, default=None)
    p.add_argument("--testmode", action="store_true",
                   help="smoke test: ~20 iters, 1 epoch (cfg.SYSTEM.TESTMODE)")
    p.add_argument("--init", type=str, default=None,
                   help="prior-stage weights (a released .pth, or a port checkpoint)")
    p.add_argument("--init-trimap", type=str, default=None,
                   help="separate trimap-net init (s1_OTVM_trimap checkpoint "
                        "or STM_weights.pth): the stage-2 load matrix loads "
                        "alpha and trimap from different artifacts "
                        "(train.py:96-104)")
    p.add_argument("--resume", type=str, default=None,
                   help="a port train-state checkpoint (networks, optimizer, step)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--repeats", type=int, default=20,
                   help="dataset x20 per epoch (train.py:283)")
    p.add_argument("--input-size", type=int, default=None,
                   help="square train crop override (default 320)")
    p.add_argument("--lr", type=float, default=None,
                   help="base LR override (default 1e-5)")
    p.add_argument("--workers", type=int, default=None,
                   help="loader threads (cfg.system.num_workers, default 8)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 network compute, fp32 master params/optimizer")
    p.add_argument("--stm-gn", action="store_true",
                   help="GroupNorm STM trunk (from-scratch recipe; frozen BN "
                        "at random init is the identity and does not train)")
    p.add_argument("--save-every", type=int, default=None,
                   help="checkpoint every N epochs (default 20; use 1 for "
                        "interruption-proof chains)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs on the CPU)")
    return p.parse_args(argv)


def single_process() -> None:
    """The port's CLIs run one process: N processes launched with a
    WORLD_SIZE would each train alone on its own batches."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        raise RuntimeError(f"WORLD_SIZE={world}: the port's training CLIs run one process on "
                           "one card; data parallelism (DDP) is ROADMAP.md §1 item 5")


def apply_overrides(cfg: Config, args: argparse.Namespace) -> None:
    """The flags both training CLIs share, onto cfg."""
    if args.data_root:
        cfg.dataset.path = args.data_root
    if args.testmode:
        cfg.system.testmode = True
    if args.epochs:
        cfg.train.total_epochs = args.epochs
    if args.batch_size:
        cfg.train.batch_size = args.batch_size
    if args.input_size:
        cfg.train.train_input_size = (args.input_size, args.input_size)
    if args.lr:
        cfg.train.base_lr = args.lr
    if args.workers is not None:
        cfg.system.num_workers = args.workers
    if args.bf16:
        cfg.train.bf16 = True
    if args.stm_gn:
        cfg.stm_norm = "gn"


def resume(path: Optional[str], state, iters_per_epoch: int, total_epochs: int, logger) -> int:
    """restore_train_state from `path` where it exists; returns the epoch to
    start at, from the restored step (the reference has no resume:
    start_epoch=0, train.py:127)."""
    if not path:
        return 0
    if not os.path.exists(path):
        logger.info(f"--resume {path}: no checkpoint yet, fresh start")
        return 0
    restore_train_state(path, state)
    start_epoch = min(state.step // iters_per_epoch, total_epochs)
    logger.info(f"resumed at step {state.step} (epoch {start_epoch})")
    return start_epoch


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Trains; returns {'state': the TrainState, 'losses': the logged
    losses, 'start_epoch', 'run_dir'}."""
    args = parse_args(argv)
    single_process()
    device = resolve_device(args.device)
    cfg = get_cfg_defaults()
    cfg.train.stage = args.stage
    apply_overrides(cfg, args)
    if args.save_every:
        cfg.train.save_every_epoch = args.save_every

    model_name = get_model_name(cfg)
    logger, run_dir = create_logger(cfg.system.outdir, model_name)
    logger.info(f"stage {args.stage} | device {device} | batch {cfg.train.batch_size}")
    import yaml
    with open(os.path.join(run_dir, "config.yaml"), "w") as f:   # train.py:76-77
        yaml.safe_dump(dataclasses.asdict(cfg), f)

    hw = cfg.train.train_input_size
    if args.stage == 4:
        dataset = VM108Train(cfg.dataset.path, hw, cfg.train.frame_num)
    else:
        dataset = DIMTrain.from_adobe_layout(cfg.dataset.path, image_shape=hw,
                                             sample_length=cfg.train.frame_num)
    iters_per_epoch = max(len(dataset) * args.repeats // cfg.train.batch_size, 1)

    # a fresh optimizer: loading weights in place keeps its parameters
    state = init_train_state(cfg, cfg.system.random_seed, iters_per_epoch, device=device)
    if args.init:
        if args.init.endswith(".pth"):
            stm_sd, fba_sd = load_pth(args.init)
            if fba_sd:
                state.fba.load_state_dict(fba_sd, strict=True)
            if stm_sd:
                state.stm.load_state_dict(stm_sd, strict=True)
        else:
            restore_params_only(args.init, state)
    if args.init_trimap:
        if args.init_trimap.endswith(".pth"):
            state.stm.load_state_dict(load_pth(args.init_trimap)[0], strict=True)
        else:
            restore_params_only(args.init_trimap, state, nets=("stm",))
    start_epoch = resume(args.resume, state, iters_per_epoch, cfg.train.total_epochs, logger)

    train_step = make_train_step(cfg)
    viz_forward = None
    loss_meter, timer, losses = AverageMeter(), StepTimer(), []
    total_epochs = 1 if cfg.system.testmode else cfg.train.total_epochs
    image_freq = cfg.train.image_freq if cfg.train.image_freq > 0 else None
    for epoch in range(start_epoch, total_epochs):
        if args.stage == 4:
            dataset.max_skip = vm108_max_skip_for_epoch(epoch, cfg.train.total_epochs)
        idx = epoch_indices(len(dataset), epoch, args.repeats, cfg.system.random_seed)
        loader = Loader(dataset, idx, cfg.train.batch_size, seed=cfg.system.random_seed + epoch,
                        num_threads=cfg.system.num_workers)
        # the loss stays on the device between log lines: one sync per 50
        # steps (the reference syncs at PRINT_FREQ, train.py:379-386)
        loss_acc, n_acc = None, 0
        for i, batch in enumerate(loader):
            if cfg.system.testmode and i > 20:
                break
            wire = encode_wire(batch)
            state, metrics = train_step(state, wire)
            loss_acc = metrics["loss"] if loss_acc is None else loss_acc + metrics["loss"]
            n_acc += 1
            if image_freq and i % image_freq == 0:
                viz_forward = viz_forward or make_viz_forward(cfg)
                save_train_grid(os.path.join(run_dir, "images", f"e{epoch}_i{i}.jpg"), batch,
                                viz_forward(state, wire))
            dt = timer.tick()
            if i % 50 == 0:
                loss = float(metrics["loss"])
                losses.append(loss)
                loss_meter.update(float(loss_acc) / n_acc, n_acc)
                loss_acc, n_acc = None, 0
                comps = " ".join(f"{k}={float(metrics[k]):.4f}"
                                 for k in ("L_alpha_comp", "L_lap", "L_grad", "L_tri"))
                logger.info(f"E{epoch} I{i} loss {loss:.4f} ({loss_meter.avg:.4f}) {comps} "
                            f"{dt * 1000:.0f} ms/it")
        if (epoch + 1) % cfg.train.save_every_epoch == 0 or epoch == total_epochs - 1:
            save_train_state(os.path.join(run_dir, f"ckpt_e{epoch + 1}"), state)
            save_train_state(os.path.join("weights", model_name), state)
            logger.info(f"saved checkpoint at epoch {epoch + 1}")
    return dict(state=state, losses=losses, start_epoch=start_epoch, run_dir=run_dir)


if __name__ == "__main__":
    main()
