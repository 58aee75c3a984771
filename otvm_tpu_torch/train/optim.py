"""RAdam and the per-iteration learning-rate schedules, counterpart of
otvm_tpu/train/optim.py.

The reference's optimizer is RAdam's "buffer variant" (utils/optimizer.py:
5-94) with decoupled weight decay, and no update at all, weight decay
included, while the rectification term is undefined (N_sma < 5: steps 1-5
with beta2 = 0.999).  Its schedules are applied per iteration
(train.py:390-393): stair (x0.1 from 90% of the iterations on), poly
((1 - t/T)^0.9) and const.

The step's scalars are computed as the JAX package computes them: in fp32,
(1 - beta2^t) by expm1, so the updates agree with it to the rounding of the
elementwise products.  As in the JAX package's `radam`, the step count
lives on the device (`RAdam.device_step`, a 0-d int64 tensor beside the
parameters, advanced there), and the learning rate, N_sma, the
rectification, the step size and the decay are 0-d tensors computed from
it; the hold while N_sma < 5 is a select (a zero step size), not a branch.
So a step reads nothing on the host, and a CUDA graph of it
(train/graphs.py) replays each step's own scalars.  The host keeps the
count too, as an int in the parameter group (what state_dict() saves).
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, List, Tuple, Union

import torch

Step = Union[int, torch.Tensor]
Schedule = Callable[[Step], torch.Tensor]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def stair_schedule(base_lr: float, total_iters: int) -> Schedule:
    def fn(step: Step) -> torch.Tensor:
        progress = _f32(step - 1) / float(total_iters)
        return torch.where(progress < 0.9, base_lr, base_lr * 0.1)
    return fn


def poly_schedule(base_lr: float, total_iters: int, power: float = 0.9) -> Schedule:
    def fn(step: Step) -> torch.Tensor:
        t = _f32(step - 1) / float(total_iters)
        return base_lr * (1.0 - t) ** power
    return fn


def const_schedule(base_lr: float, total_iters: int = 0) -> Schedule:
    def fn(step: Step) -> torch.Tensor:
        device = step.device if isinstance(step, torch.Tensor) else None
        return torch.full((), base_lr, dtype=torch.float32, device=device)
    return fn


SCHEDULES = {"stair": stair_schedule, "poly": poly_schedule, "const": const_schedule}


def rectified_scalars(t: torch.Tensor, lr: torch.Tensor, betas: Tuple[float, float],
                      weight_decay: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """RAdam's (step size, decay factor) of step t (fp32) at learning rate
    lr, as 0-d tensors on their device: -rect * lr and -weight_decay * lr,
    both 0 while N_sma < 5 (a select, not a branch)."""
    b1, b2 = betas
    one_minus_beta2_t = -torch.expm1(t * float(math.log(b2)))
    beta2_t = 1.0 - one_minus_beta2_t
    n_sma_max = _f32(2.0 / (1 - b2) - 1.0)
    n_sma = n_sma_max - 2.0 * t * beta2_t / one_minus_beta2_t
    rect = torch.sqrt(one_minus_beta2_t * (n_sma - 4) / (n_sma_max - 4)
                      * (n_sma - 2) / n_sma * n_sma_max / (n_sma_max - 2)
                      ) / (1 - _f32(b1) ** t)
    active = n_sma >= 5.0
    return (torch.where(active, -rect * lr, 0.0),
            torch.where(active, _f32(-weight_decay) * lr, 0.0))


def _capturing(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


class RAdam(torch.optim.Optimizer):
    """Reference-exact RAdam (utils/optimizer.py:28-94).

    lr is a float or a schedule, step -> lr (an int or a 0-d tensor in,
    a 0-d fp32 tensor on its device out), read at every step (steps count
    from 1).  State: exp_avg and exp_avg_sq per parameter, and one step
    count: `device_step` on the parameters' device, mirrored on the host
    as param_groups[0]["step"].  A parameter without a gradient (one
    that the loss does not reach: the STM at joint stage 1, the FBA in
    trimap training) takes a zero gradient, as jax.grad gives the JAX
    package's optimizer: its moments decay and, from step 6, its weight
    decay applies.  Freezing a network means leaving its parameters out of
    the optimizer.

    A step is three parts: `prepare` (host: the moments at the first
    step, the host's count onto the device where they differ), `update`
    (device only: what a CUDA graph captures) and `advance` (host: the
    mirror).  `step` runs all three."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 lr: Union[float, Schedule] = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                                      step=0))
        if len(self.param_groups) != 1:
            raise ValueError("RAdam keeps one step count: pass one parameter group")
        # a schedule is code, not state: it stays out of state_dict()
        self.schedule: Schedule = lr if callable(lr) else const_schedule(lr)
        device = self.param_groups[0]["params"][0].device
        self.device_step = torch.zeros((), dtype=torch.int64, device=device)
        self._device_at = 0                 # the count device_step holds between steps

    def prepare(self) -> None:
        """The host's part before a step's device work: makes the moments
        at the first step (never inside a CUDA-graph capture) and puts the
        host's count on the device where it was set there (load_state_dict,
        convert.radam_state_from_jax)."""
        group = self.param_groups[0]
        fresh = [p for p in group["params"] if not self.state[p]]
        if fresh and _capturing(fresh[0]):
            raise RuntimeError("RAdam's moments are made at the first step, which must not be "
                               "captured: run one step eagerly first")
        for p in fresh:
            self.state[p]["exp_avg"] = torch.zeros_like(p)
            self.state[p]["exp_avg_sq"] = torch.zeros_like(p)
        if group["step"] != self._device_at:
            self.device_step.fill_(group["step"])
            self._device_at = group["step"]

    def advance(self) -> None:
        """The host's part after a step's device work: the host's count."""
        self.param_groups[0]["step"] += 1
        self._device_at += 1

    @torch.no_grad()
    def step(self, closure=None) -> List[torch.Tensor]:
        """One step; returns the updates it added (the parameters' deltas,
        weight decay included), zeros on the steps that do not update."""
        if closure is not None:
            raise ValueError("RAdam.step takes no closure")
        self.prepare()
        updates = self.update()
        self.advance()
        return updates

    def _scalars(self, group: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """Advances the device's count; that step's (step size, decay
        factor), 0-d tensors on the device."""
        self.device_step += 1
        return rectified_scalars(_f32(self.device_step), self.schedule(self.device_step),
                                 group["betas"], group["weight_decay"])

    @torch.no_grad()
    def update(self) -> List[torch.Tensor]:
        """The step's device work, after `prepare`: the moments, the count,
        the parameters.  Reads nothing on the host.  Steps that do not
        update add zeros (a parameter of -0.0 becomes +0.0, as in JAX's
        radam)."""
        group = self.param_groups[0]
        b1, b2 = group["betas"]
        params = group["params"]
        m = [self.state[p]["exp_avg"] for p in params]
        v = [self.state[p]["exp_avg_sq"] for p in params]
        torch._foreach_mul_(m, b1)
        torch._foreach_mul_(v, b2)
        # a zero gradient adds nothing to the moments
        fed = [i for i, p in enumerate(params) if p.grad is not None]
        grads = [params[i].grad for i in fed]
        torch._foreach_add_([m[i] for i in fed], torch._foreach_mul(grads, _f32(1 - b1).item()))
        torch._foreach_add_([v[i] for i in fed], torch._foreach_mul(
            torch._foreach_mul(grads, grads), _f32(1 - b2).item()))

        step_size, decay = self._scalars(group)
        updates = torch._foreach_mul(m, step_size)
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, group["eps"])
        torch._foreach_div_(updates, denom)
        if group["weight_decay"]:
            torch._foreach_add_(updates, torch._foreach_mul(params, decay))
        torch._foreach_add_(params, updates)
        return updates

    def load_state_dict(self, state_dict: dict) -> None:
        """torch's load, into the tensors this optimizer holds: moments it
        has are overwritten in place (zeroed where the file has none), as
        a CUDA graph of its step holds their addresses; the count reaches
        the device at the next step."""
        held = {p: s for p, s in self.state.items() if s}
        super().load_state_dict(state_dict)
        for p, old in held.items():
            new = self.state.get(p) or {}
            for key, x in old.items():
                if key in new:
                    x.copy_(new[key])
                else:
                    x.zero_()
            self.state[p] = old
