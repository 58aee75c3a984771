"""RAdam with its step-dependent scalars read on the host: the port's
optimizer before its step count moved to the device, kept verbatim as the
reference that the device-step RAdam (otvm_tpu_torch/train/optim.py) must
equal bit for bit on the CPU (tests/test_torch_train_graphs.py).  Its
`.item()` and `bool()` reads are what a CUDA-graph capture would freeze."""
from __future__ import annotations

import math
from typing import Callable, Iterable, List, Union

import torch

Schedule = Callable[[int], torch.Tensor]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def stair_schedule(base_lr: float, total_iters: int) -> Schedule:
    def fn(step: int) -> torch.Tensor:
        progress = _f32(step - 1) / float(total_iters)
        return _f32(base_lr if bool(progress < 0.9) else base_lr * 0.1)
    return fn


def poly_schedule(base_lr: float, total_iters: int, power: float = 0.9) -> Schedule:
    def fn(step: int) -> torch.Tensor:
        t = _f32(step - 1) / float(total_iters)
        return base_lr * (1.0 - t) ** power
    return fn


def const_schedule(base_lr: float, total_iters: int = 0) -> Schedule:
    return lambda step: _f32(base_lr)


SCHEDULES = {"stair": stair_schedule, "poly": poly_schedule, "const": const_schedule}


class RAdam(torch.optim.Optimizer):
    """Reference-exact RAdam (utils/optimizer.py:28-94).

    lr is a float or a schedule, step -> lr, read at every step (steps count
    from 1).  State: exp_avg and exp_avg_sq per parameter, and one step
    count (in the parameter group).  A parameter without a gradient (one
    that the loss does not reach: the STM at joint stage 1, the FBA in
    trimap training) takes a zero gradient, as jax.grad gives the JAX
    package's optimizer: its moments decay and, from step 6, its weight
    decay applies.  Freezing a network means leaving its parameters out of
    the optimizer."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 lr: Union[float, Schedule] = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                                      step=0))
        if len(self.param_groups) != 1:
            raise ValueError("RAdam keeps one step count: pass one parameter group")
        # a schedule is code, not state: it stays out of state_dict()
        self.schedule: Schedule = lr if callable(lr) else const_schedule(lr)

    @torch.no_grad()
    def step(self, closure=None) -> List[torch.Tensor]:
        """One step; returns the updates it added (the parameters' deltas,
        weight decay included), zeros on the steps that do not update."""
        if closure is not None:
            raise ValueError("RAdam.step takes no closure")
        group = self.param_groups[0]
        b1, b2 = group["betas"]
        group["step"] += 1
        t = _f32(group["step"])
        lr = self.schedule(group["step"])

        params = group["params"]
        for p in params:
            if not self.state[p]:
                self.state[p]["exp_avg"] = torch.zeros_like(p)
                self.state[p]["exp_avg_sq"] = torch.zeros_like(p)
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

        one_minus_beta2_t = -torch.expm1(t * float(math.log(b2)))
        beta2_t = 1.0 - one_minus_beta2_t
        n_sma_max = _f32(2.0 / (1 - b2) - 1.0)
        n_sma = n_sma_max - 2.0 * t * beta2_t / one_minus_beta2_t
        if not bool(n_sma >= 5.0):
            return [torch.zeros_like(p) for p in params]
        rect = torch.sqrt(one_minus_beta2_t * (n_sma - 4) / (n_sma_max - 4)
                          * (n_sma - 2) / n_sma * n_sma_max / (n_sma_max - 2)
                          ) / (1 - _f32(b1) ** t)
        step_size = (-rect * lr).item()
        updates = torch._foreach_mul(m, step_size)
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, group["eps"])
        torch._foreach_div_(updates, denom)
        if group["weight_decay"]:
            decay = torch._foreach_mul(params, (_f32(-group["weight_decay"]) * lr).item())
            torch._foreach_add_(updates, decay)
        torch._foreach_add_(params, updates)
        return updates
