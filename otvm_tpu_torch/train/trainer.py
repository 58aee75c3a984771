"""Stage-wise trainer, counterpart of otvm_tpu/train/trainer.py.

The stage matrix (train.py:86-168, 305-327):
  s1  alpha alone, GT trimaps every frame (the trimap net unused)
  s2  alpha trained, trimap net frozen
  s3  trimap net trained, alpha frozen
  s4  everything trained end to end
A frozen network's parameters are left out of the optimizer and need no
gradient; gradients still flow through its activations (the reference
never detaches it either: its trimap CE reaches the alpha net through the
frozen trimap net).  RAdam (lr 1e-5, weight decay 1e-4) with the stair
schedule per iteration; loss = L_alpha_comp + L_lap + L_grad (+ L_tri from
stage 2 on) (train.py:355-366).

A train step runs on the device of the state's modules: the batch (numpy
or tensors, float or encode_wire's uint8) is copied there and decoded
there.  State is updated in place; the step returns it for symmetry with
the JAX package, and its metrics as device tensors (reading them waits for
the device).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Mapping, Optional

import torch

from .. import resolve_device, set_fp32_numerics
from ..config import Config
from ..data.loader import decode_wire
from ..models.fba import FBA
from ..models.otvm import init_models, joint_train_forward, trimap_train_forward
from ..models.stm import STM
from . import losses as L
from .optim import SCHEDULES, RAdam


@dataclasses.dataclass
class TrainState:
    stm: STM
    fba: FBA
    optimizer: RAdam
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.stm.parameters()).device


def stage_trainable_mask(stage: int) -> Dict[str, bool]:
    """train.py:146-168: stage 2 freezes the trimap net (stm), stage 3 the
    alpha net (fba)."""
    return {"stm": stage != 2, "fba": stage != 3}


def make_optimizer(cfg: Config, stm: STM, fba: FBA, iters_per_epoch: int) -> RAdam:
    """RAdam over the stage's trainable parameters, with the configured
    schedule over cfg.train.total_epochs epochs."""
    total_iters = cfg.train.total_epochs * iters_per_epoch
    schedule = SCHEDULES[cfg.train.lr_strategy](cfg.train.base_lr, total_iters)
    trainable = stage_trainable_mask(cfg.train.stage)
    params = [p for name, net in (("stm", stm), ("fba", fba)) if trainable[name]
              for p in net.parameters()]
    return RAdam(params, lr=schedule, weight_decay=cfg.train.weight_decay)


def init_train_state(cfg: Config, seed: int = 0, iters_per_epoch: int = 1,
                     device=None) -> TrainState:
    """Both networks of cfg.train.stage (FBA on cfg.alpha.arch's trunk) with
    random weights drawn from `seed` (flax's default init), on CUDA unless `device` says otherwise,
    the frozen one (stage 2 or 3) without gradients, and a fresh optimizer.
    fp32 runs with TF32 off (set_fp32_numerics), as the JAX reference
    does at its highest precision."""
    device = resolve_device(device)
    set_fp32_numerics()
    stm, fba = init_models(seed, cfg.train.stage, cfg.model_scale, cfg.stm_norm, cfg.alpha.arch)
    stm, fba = stm.to(device), fba.to(device)
    trainable = stage_trainable_mask(cfg.train.stage)
    stm.requires_grad_(trainable["stm"])
    fba.requires_grad_(trainable["fba"])
    return TrainState(stm, fba, make_optimizer(cfg, stm, fba, iters_per_epoch))


def _compute_dtype(cfg: Config) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.train.bf16 else None


def _on_device(batch: Mapping, device: torch.device) -> Dict[str, torch.Tensor]:
    return decode_wire({k: torch.as_tensor(v).to(device) for k, v in batch.items()})


def _apply(state: TrainState, loss: torch.Tensor) -> None:
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1


def make_train_step(cfg: Config) -> Callable:
    """train_step(state, batch) -> (state, metrics): decode the batch on the
    device, the stage's joint forward and loss, backward, one RAdam step.
    metrics: loss, L_alpha_comp, L_lap, L_grad, L_tri (0-d tensors)."""
    stage, cdt = cfg.train.stage, _compute_dtype(cfg)

    def train_step(state: TrainState, batch: Mapping):
        batch = _on_device(batch, state.device)
        loss, aux = joint_train_forward(state.stm, state.fba, batch, stage, compute_dtype=cdt)
        _apply(state, loss)
        metrics = dict(loss=loss, **{k: aux[k] for k in ("L_alpha_comp", "L_lap", "L_grad",
                                                         "L_tri")})
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_viz_forward(cfg: Config) -> Callable:
    """viz_forward(state, batch) -> {'alphas', 'comps'}: the stage's joint
    forward without gradients, fp32, for the training image grids
    (train.py:255-275, utils/viz.py:save_train_grid); numpy [B, S, H, W, 1|3]."""
    stage = cfg.train.stage

    @torch.no_grad()
    def viz_forward(state: TrainState, batch: Mapping):
        _, aux = joint_train_forward(state.stm, state.fba, _on_device(batch, state.device), stage)
        return {k: aux[k].float().cpu().numpy() for k in ("alphas", "comps")}

    return viz_forward


def make_trimap_s1_train_step(cfg: Config) -> Callable:
    """train_s1_trimap.py's step: the STM alone, trained on the CE of its
    propagated trimaps.  Without `img` in the batch, the frames are
    composited on the device (models/trimap/model.py:57-60).  metrics: loss,
    and the uint8 argmax labels of the predicted and GT trimaps (pred_lab,
    gt_lab [B, S, H, W]) for the in-training IoU."""
    cdt = _compute_dtype(cfg)

    def train_step(state: TrainState, batch: Mapping):
        batch = _on_device(batch, state.device)
        if "img" not in batch:
            batch["img"] = batch["fg"] * batch["alpha"] + batch["bg"] * (1.0 - batch["alpha"])
        loss, aux = trimap_train_forward(state.stm, batch, compute_dtype=cdt)
        _apply(state, loss)
        return state, dict(loss=loss.detach(),
                           pred_lab=L.argmax_small(aux["pred"].detach()).to(torch.uint8),
                           gt_lab=L.argmax_small(batch["tri"]).to(torch.uint8))

    return train_step


def run_epoch(state: TrainState, train_step: Callable, batches: Iterable[Mapping]):
    """One epoch over `batches`; returns (state, the metrics averaged)."""
    acc, n = None, 0
    for batch in batches:
        state, metrics = train_step(state, batch)
        acc = metrics if acc is None else {k: acc[k] + v for k, v in metrics.items()}
        n += 1
    if acc is not None:
        acc = {k: v / n for k, v in acc.items()}
    return state, acc
