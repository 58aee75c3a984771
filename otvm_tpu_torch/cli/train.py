"""Stage-wise training from the command line, the port's train.py.

    python -m otvm_tpu_torch.cli.train --stage {1,2,3,4} [--data-root PATH] [--testmode]
        [--init CKPT.pth|FILE] [--init-trimap CKPT.pth|FILE] [--resume FILE]
        [--epochs N] [--batch-size B] [--device cuda|cpu] [--eager]

Stages (train.py:86-168 of the reference):
  1  the alpha net alone on DIM (GT trimaps every frame)
  2  alpha trained, trimap net frozen, on DIM
  3  trimap net trained, alpha frozen, on DIM
  4  both, on VideoMatting108, with the max_skip curriculum

The JAX CLI's flags, names and defaults, and `--device` (default cuda).
On CUDA each step after the first is one CUDA-graph replay
(train/graphs.py), as JAX's is one jitted dispatch: on one card, and on
each rank under torchrun, whose graph holds the rank's NCCL collectives;
`--eager` keeps the eager step, and so does the CPU (the log says which).
Checkpoints (utils/checkpoint.save_train_state files) go to
<cfg.system.outdir>/<model>/ckpt_e<N> and weights/<model> under the working
directory, every `--save-every` epochs and at the last; the run's logs and
config.yaml to <cfg.system.outdir>/<model>/.  --init chains a prior stage
(a released .pth, or a port checkpoint: its networks, a fresh optimizer),
--init-trimap the STM alone, --resume a run (networks, optimizer, step).

Data parallelism: launched as N ranks by torchrun (`torchrun
--nproc_per_node N -m otvm_tpu_torch.cli.train ...`), each rank joins the
process group (parallel/dist.py init_distributed: NCCL, one card a rank;
gloo with --device cpu), takes cfg.train.batch_size / N rows of each
global batch from the epoch's order strided by its rank (epoch_indices),
the Loader seed shared, and the step averages the gradients over the ranks
(train/trainer.py).  Rank 0 alone owns the run directory: it creates the
logger and config.yaml (the JAX CLI has every process call create_logger),
draws the image grids, writes the log lines (the losses averaged over the
ranks, the global batch's, as JAX logs them) and saves the checkpoints.
WORLD_SIZE > 1 without the rest of torchrun's rendezvous raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import math
import os
import time
from typing import Dict, Iterator, List, Optional, Sequence

import torch

from ..config import Config, get_cfg_defaults, get_model_name
from ..convert import load_pth
from ..data.datasets import DIMTrain, VM108Train, vm108_max_skip_for_epoch
from ..data.loader import Loader, encode_wire, epoch_indices
from ..parallel import dist as D
from ..train.graphs import refusal
from ..train.trainer import init_train_state, make_train_step, make_viz_forward
from ..utils import trace
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
    p.add_argument("--eager", action="store_true",
                   help="the eager train step, not its CUDA-graph replay (the default on "
                        "CUDA, alone or on each NCCL rank under torchrun)")
    return p.parse_args(argv)


def step_mode(args: argparse.Namespace, state) -> str:
    """The log's word on the train step: replayed from a CUDA graph (on
    each of N ranks), or eager and why."""
    ranks = "" if state.group is None else \
        f" on each of {D.process_count()} {D.group_backend(state.group)} ranks"
    if args.eager:
        return f"eager{ranks} (--eager)"
    why = refusal(state)
    return f"eager ({why})" if why else \
        f"one CUDA-graph replay a step{ranks}, after an eager first step"


def per_rank_batch(cfg: Config) -> int:
    """This rank's rows of the global batch (train.py:179)."""
    world = D.process_count()
    if cfg.train.batch_size % world:
        raise ValueError(f"global batch {cfg.train.batch_size} over {world} ranks")
    return cfg.train.batch_size // world


def rank_logger(outdir: str, name: str):
    """(logger, run directory): create_logger's on rank 0; on the other
    ranks a logger that writes nothing, and no directory."""
    if D.process_index() == 0:
        return create_logger(outdir, name)
    logger = logging.getLogger(f"otvm.{name}.rank{D.process_index()}")
    logger.propagate = False
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    return logger, None


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


def training_set(cfg: Config):
    """The stage's training data: VM108 clips at stage 4, DIM composites
    before (the trimap-s1 pretrain's too)."""
    hw = cfg.train.train_input_size
    if cfg.train.stage == 4:
        return VM108Train(cfg.dataset.path, hw, cfg.train.frame_num)
    return DIMTrain.from_adobe_layout(cfg.dataset.path, image_shape=hw,
                                      sample_length=cfg.train.frame_num)


def epoch_loader(cfg: Config, dataset, epoch: int, repeats: int, batch_size: int) -> Loader:
    """This rank's batches of `epoch`, each epoch's order and augmentations
    from cfg.system.random_seed (stage 4 with that epoch's max_skip)."""
    if cfg.train.stage == 4:
        dataset.max_skip = vm108_max_skip_for_epoch(epoch, cfg.train.total_epochs)
    idx = epoch_indices(len(dataset), epoch, repeats, cfg.system.random_seed,
                        D.process_index(), D.process_count())
    return Loader(dataset, idx, batch_size, seed=cfg.system.random_seed + epoch,
                  num_threads=cfg.system.num_workers)


def timed_batches(loader: Loader, waits: List[float]) -> Iterator[Dict]:
    """`loader`'s batches; appends to `waits` the seconds each one took to
    come (the loop's wait on the Loader), each wait a data.wait span
    (utils/trace.py)."""
    batches = iter(loader)
    try:
        while True:
            t0 = time.perf_counter()
            try:
                with trace.span("data.wait"):
                    batch = next(batches)
            except StopIteration:
                return
            waits.append(time.perf_counter() - t0)
            yield batch
    finally:
        batches.close()


def stop_if_not_finite(value: float, window, epoch: int, i: int, logger) -> None:
    """Raises FloatingPointError, and logs it, where a logged loss (the
    ranks' mean over the steps since the last line) is not finite; names
    the first step of this rank's `window` (its losses, one 0-d tensor a
    step, through step i) whose own loss is not finite."""
    if math.isfinite(value):
        return
    bad = (~torch.isfinite(torch.stack(window))).nonzero()
    first = (f"E{epoch} I{i - len(window) + 1 + int(bad[0])}" if len(bad)
             else "on another rank")
    msg = f"E{epoch} I{i}: the logged loss is {value}; the first non-finite step: {first}"
    logger.error(msg)
    raise FloatingPointError(msg)


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
    losses (each line's step), 'averages' (their running averages),
    'steps' (the step count at each line), 'loader_wait_s' (the loop's
    wait on its batches), 'start_epoch', 'run_dir'}.  A logged loss that is not finite stops the run (FloatingPointError)."""
    args = parse_args(argv)
    device = D.init_distributed(args.device)
    rank, group = D.process_index(), D.data_group()
    cfg = get_cfg_defaults()
    cfg.train.stage = args.stage
    apply_overrides(cfg, args)
    if args.save_every:
        cfg.train.save_every_epoch = args.save_every
    batch_size = per_rank_batch(cfg)

    model_name = get_model_name(cfg)
    logger, run_dir = rank_logger(cfg.system.outdir, model_name)
    logger.info(f"stage {args.stage} | device {device} | ranks {D.process_count()} "
                f"| global batch {cfg.train.batch_size}")
    if rank == 0:
        import yaml
        with open(os.path.join(run_dir, "config.yaml"), "w") as f:   # train.py:76-77
            yaml.safe_dump(dataclasses.asdict(cfg), f)

    dataset = training_set(cfg)
    iters_per_epoch = max(len(dataset) * args.repeats // cfg.train.batch_size, 1)

    # a fresh optimizer: loading weights in place keeps its parameters
    state = init_train_state(cfg, cfg.system.random_seed, iters_per_epoch, device=device,
                             group=group)
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

    train_step = make_train_step(cfg, graphs=False if args.eager else None)
    logger.info(f"train step: {step_mode(args, state)}")
    viz_forward = None
    loss_meter, timer, losses, averages, steps = AverageMeter(), StepTimer(), [], [], []
    waits = []
    total_epochs = 1 if cfg.system.testmode else cfg.train.total_epochs
    image_freq = cfg.train.image_freq if cfg.train.image_freq > 0 else None
    for epoch in range(start_epoch, total_epochs):
        loader = epoch_loader(cfg, dataset, epoch, args.repeats, batch_size)
        # the loss stays on the device between log lines: one sync (and one
        # collective) per 50 steps (the reference syncs at PRINT_FREQ,
        # train.py:379-386); `window` keeps each step's, for the first
        # non-finite one
        loss_acc, n_acc, window = None, 0, []
        for i, batch in enumerate(timed_batches(loader, waits)):
            if cfg.system.testmode and i > 20:
                break
            wire = encode_wire(batch)
            state, metrics = train_step(state, wire)
            loss_acc = metrics["loss"] if loss_acc is None else loss_acc + metrics["loss"]
            n_acc += 1
            window.append(metrics["loss"])
            if image_freq and i % image_freq == 0 and rank == 0:
                viz_forward = viz_forward or make_viz_forward(cfg)
                save_train_grid(os.path.join(run_dir, "images", f"e{epoch}_i{i}.jpg"), batch,
                                viz_forward(state, wire))
            dt = timer.tick()
            if i % 50 == 0:
                names = ("loss", "L_alpha_comp", "L_lap", "L_grad", "L_tri")
                loss, *comps, acc = (x.item() for x in D.all_reduce_mean(
                    [metrics[k] for k in names] + [loss_acc / n_acc], group))
                stop_if_not_finite(acc, window, epoch, i, logger)
                losses.append(loss)
                loss_meter.update(acc, n_acc)
                averages.append(loss_meter.avg)
                steps.append(state.step)
                loss_acc, n_acc, window = None, 0, []
                comps = " ".join(f"{k}={v:.4f}" for k, v in zip(names[1:], comps))
                logger.info(f"E{epoch} I{i} loss {loss:.4f} ({loss_meter.avg:.4f}) {comps} "
                            f"{dt * 1000:.0f} ms/it")
        if rank == 0 and ((epoch + 1) % cfg.train.save_every_epoch == 0
                          or epoch == total_epochs - 1):
            save_train_state(os.path.join(run_dir, f"ckpt_e{epoch + 1}"), state)
            save_train_state(os.path.join("weights", model_name), state)
            logger.info(f"saved checkpoint at epoch {epoch + 1}")
    return dict(state=state, losses=losses, averages=averages, steps=steps,
                loader_wait_s=sum(waits), start_epoch=start_epoch, run_dir=run_dir)


if __name__ == "__main__":
    main()
    D.shutdown()
