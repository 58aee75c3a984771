"""Whether the train step is right: the readings of the program's first
steps held to the reference's (reference/train.py, fp32, TF32 off) from
the same weights on the same global batches.

RAdam makes no update at all while its rectification is undefined (steps
1-5 at beta2 0.999), so three steps would leave every parameter where it
was on both sides and the update itself unjudged.  The check therefore
follows `check_steps` = 6 steps, the first of them updating at the last.

  loss_rel     the largest relative gap of a step's loss (at several
               ranks, the ranks' mean: the global batch's loss)
  grad_gap     the first gradient as the optimizer got it, from its first
               moment after step 1 (exp_avg / (1 - beta1)); by the worst
               leaf: |norm(program) - norm(reference)| over the larger of
               the reference's norm of that leaf and of the median leaf
  change_gap   the parameters' change over the steps, by the worst leaf as
               above, leaving out leaves whose reference gradient is under
               a thousandth of the median leaf's (moved by round-off alone)
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from ..reference import nets
from ..reference.precision import tf32
from ..reference.train import RAdam, decode, joint_loss

RULE = 1e-3                 # a leaf's gradient under RULE x the median leaf's: not judged


def leaf_norms(tensors: Sequence[torch.Tensor]) -> List[float]:
    return torch.stack([t.float().norm() for t in tensors]).cpu().tolist()


def leaf_gaps(got: Sequence[float], want: Sequence[float], keep=None) -> torch.Tensor:
    """Each leaf's |norm(program) - norm(reference)| over the larger of
    the reference's norm of that leaf and of the median leaf."""
    want_t, got_t = torch.tensor(want, dtype=torch.float64), torch.tensor(got, dtype=torch.float64)
    if keep is not None:
        want_t, got_t = want_t[keep], got_t[keep]
    floor = torch.maximum(want_t, want_t.median())
    return (got_t - want_t).abs() / floor.clamp_min(1e-30)


def worst_leaf(got: Sequence[float], want: Sequence[float], keep=None) -> float:
    return float(leaf_gaps(got, want, keep).max())


def reference_readings(cell, states, batches, device, dtype=None, rows=None,
                       model=None) -> Dict[str, list]:
    """The reference's readings over the global batches: losses, the first
    gradient's and the change's leaf norms.  dtype / `model` (a dict of
    reference modules already lowered, precision.py) and `rows` (only those
    rows of each batch) make the checks' controls and faults."""
    c = cell.config
    m = model or nets.build("joint", c.get("model_scale", 1))
    if model is None:
        for k, net in m.items():
            net.load_state_dict(states[k])
            net.to(device)
    named = [(f"{k}.{n}", p) for k in ("stm", "fba")
             for n, p in getattr(m[k], "module", m[k]).named_parameters()]
    params = [p for _, p in named]
    p0 = [p.detach().clone() for p in params]
    opt = RAdam(params, c["base_lr"], c["weight_decay"])
    losses, grad1 = [], None
    for i, b in enumerate(batches):
        b = {k: torch.as_tensor(v[rows] if rows is not None else v).to(device)
             for k, v in b.items()}
        loss, _ = joint_loss(m["stm"], m["fba"], decode(b), dtype)
        for p in params:
            p.grad = None
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if i == 0:
            grad1 = leaf_norms([x / (1 - opt.betas[0]) for x in opt.m])
    return {"names": [n for n, _ in named], "losses": losses, "grad1": grad1,
            "change": leaf_norms([p.detach() - q for p, q in zip(params, p0)])}


def compare(got: Dict[str, list], want: Dict[str, list]) -> Dict[str, float]:
    if got["names"] != want["names"]:
        raise ValueError("the program's parameters and the reference's differ in name or order")
    g1 = torch.tensor(want["grad1"], dtype=torch.float64)
    keep = g1 >= RULE * g1.median()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    return {"loss_rel": loss_rel, "grad_gap": worst_leaf(got["grad1"], want["grad1"]),
            "change_gap": worst_leaf(got["change"], want["change"], keep)}


def check(cell, states, batches, got, device) -> Dict[str, float]:
    """The program's readings `got` against the reference's (fp32, TF32 off)."""
    with tf32(False):
        return compare(got, reference_readings(cell, states, batches, device))
