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
the device).  On a CUDA card the step replays a CUDA graph, as JAX's is one
jitted executable (train/graphs.py: the key's first step eager, then one
replay a step), alone or as one rank of an NCCL group; `graphs=False`
keeps the eager step, and so do the CPU and a gloo group.

Data parallelism (the JAX package's data mesh): a state made with a
process `group` (parallel/dist.py) is one rank's copy; every rank starts
from the same seeded init (checked), takes its rows of the global batch,
and after the backward pass the gradients are averaged over the ranks, so
every rank takes the 1-process step on the global batch.  The exclusion
loss's batch means are taken over the global batch too.  Over NCCL each
rank replays one CUDA graph a step with those collectives inside it, the
counterpart of the JAX package's mesh-sharded jitted step; the eager step
runs the same arithmetic in the same order.  A step's metrics are this
rank's rows' (all_reduce_mean gives the global batch's, at log lines).
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
from ..parallel import dist as D
from ..utils import trace
from . import losses as L
from .graphs import TrainStepGraphs, refusal
from .optim import SCHEDULES, RAdam


@dataclasses.dataclass
class TrainState:
    stm: STM
    fba: FBA
    optimizer: RAdam
    step: int = 0
    group: Optional[object] = None      # the data-parallel ranks (None: one process)

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
                     device=None, group=None) -> TrainState:
    """Both networks of cfg.train.stage (FBA on cfg.alpha.arch's trunk) with
    random weights drawn from `seed` (flax's default init), on CUDA unless `device` says otherwise,
    the frozen one (stage 2 or 3) without gradients, and a fresh optimizer.
    fp32 runs with TF32 off (set_fp32_numerics), as the JAX reference
    does at its highest precision.  group: this rank's process group
    (parallel/dist.py data_group()); every rank must draw the same weights,
    and a rank whose differ raises."""
    device = resolve_device(device)
    set_fp32_numerics()
    stm, fba = init_models(seed, cfg.train.stage, cfg.model_scale, cfg.stm_norm, cfg.alpha.arch)
    stm, fba = stm.to(device), fba.to(device)
    if group is not None and not D.ranks_equal(
            [*stm.state_dict().values(), *fba.state_dict().values()], group):
        raise RuntimeError(f"the ranks' inits from seed {seed} differ")
    trainable = stage_trainable_mask(cfg.train.stage)
    stm.requires_grad_(trainable["stm"])
    fba.requires_grad_(trainable["fba"])
    return TrainState(stm, fba, make_optimizer(cfg, stm, fba, iters_per_epoch), group=group)


def _compute_dtype(cfg: Config) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.train.bf16 else None


def _on_device(batch: Mapping, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _apply(state: TrainState, loss: torch.Tensor) -> None:
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if state.group is not None:
        D.all_reduce_gradients(state.optimizer.param_groups[0]["params"], state.group)
    state.optimizer.step()
    state.step += 1


def _train_step(forward: Callable, static: tuple, graphs: Optional[bool]) -> Callable:
    """The train step of `forward` (state, the wire batch's tensors on the
    device) -> (loss, metrics): from CUDA graphs (train/graphs.py) where
    `graphs` is True, or None and graphs can serve the state (on CUDA,
    alone or with an NCCL group: train/graphs.py refusal); else eagerly.
    graphs=True where graphs cannot serve raises.  Each step is a
    train.step span (utils/trace.py; ids step and rank) and adds one to the
    counter train.steps; the eager step's spans inside it are train.upload
    and train.device_step, the graphed one's train/graphs.py's."""
    compiled = None if graphs is False else TrainStepGraphs(forward, static)

    def train_step(state: TrainState, batch: Mapping):
        why = None if compiled is None else refusal(state)
        if why and graphs:
            raise ValueError(f"graphs=True: {why}")
        with trace.span("train.step", step=state.step, rank=D.process_index()):
            if compiled is not None and why is None:
                metrics = compiled(state, batch)
            else:
                with trace.span("train.upload"):
                    on_device = _on_device(batch, state.device)
                with trace.span("train.device_step"):
                    loss, metrics = forward(state, on_device)
                    _apply(state, loss)
                metrics = {k: v.detach() for k, v in metrics.items()}
        trace.count("train.steps")
        return state, metrics

    train_step.graphs = compiled
    return train_step


def make_train_step(cfg: Config, remat: bool = False, graphs: Optional[bool] = None) -> Callable:
    """train_step(state, batch) -> (state, metrics): decode the batch on the
    device, the stage's joint forward and loss, backward, one RAdam step.
    metrics: loss, L_alpha_comp, L_lap, L_grad, L_tri (0-d tensors).
    remat: recompute the network calls and frame losses in the backward
    pass (joint_train_forward's remat, the JAX package's OTVM_REMAT=1).
    graphs: None replays the step from a CUDA graph on a CUDA card, alone
    or on each rank of an NCCL group (train/graphs.py; the eager step on
    the CPU and with a gloo group), False keeps the eager step (the
    lockstep checks need it), True insists on graphs.  train_step.graphs is
    the TrainStepGraphs (None when False)."""
    stage, cdt = cfg.train.stage, _compute_dtype(cfg)

    def forward(state: TrainState, batch: Dict[str, torch.Tensor]):
        loss, aux = joint_train_forward(state.stm, state.fba, decode_wire(batch), stage,
                                        compute_dtype=cdt, remat=remat, group=state.group)
        return loss, dict(loss=loss, **{k: aux[k] for k in ("L_alpha_comp", "L_lap", "L_grad",
                                                            "L_tri")})

    return _train_step(forward, ("joint", stage, cdt, remat), graphs)


def make_viz_forward(cfg: Config) -> Callable:
    """viz_forward(state, batch) -> {'alphas', 'comps'}: the stage's joint
    forward without gradients, fp32, for the training image grids
    (train.py:255-275, utils/viz.py:save_train_grid); numpy [B, S, H, W, 1|3].
    It runs on this rank alone (no collective), so rank 0 may call it."""
    stage = cfg.train.stage

    @torch.no_grad()
    def viz_forward(state: TrainState, batch: Mapping):
        _, aux = joint_train_forward(state.stm, state.fba,
                                     decode_wire(_on_device(batch, state.device)), stage)
        return {k: aux[k].float().cpu().numpy() for k in ("alphas", "comps")}

    return viz_forward


def make_trimap_s1_train_step(cfg: Config, graphs: Optional[bool] = None) -> Callable:
    """train_s1_trimap.py's step: the STM alone, trained on the CE of its
    propagated trimaps.  Without `img` in the batch, the frames are
    composited on the device (models/trimap/model.py:57-60).  metrics: loss,
    and the uint8 argmax labels of the predicted and GT trimaps (pred_lab,
    gt_lab [B, S, H, W]) for the in-training IoU.  graphs: as
    make_train_step's."""
    cdt = _compute_dtype(cfg)

    def forward(state: TrainState, batch: Dict[str, torch.Tensor]):
        batch = decode_wire(batch)
        if "img" not in batch:
            batch["img"] = batch["fg"] * batch["alpha"] + batch["bg"] * (1.0 - batch["alpha"])
        loss, aux = trimap_train_forward(state.stm, batch, compute_dtype=cdt)
        return loss, dict(loss=loss, pred_lab=L.argmax_small(aux["pred"].detach()).to(torch.uint8),
                          gt_lab=L.argmax_small(batch["tri"]).to(torch.uint8))

    return _train_step(forward, ("trimap_s1", cdt), graphs)


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
