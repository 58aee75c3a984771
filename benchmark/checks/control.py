"""The checks' controls and planted faults, read at a cell's own size:
the reference put in the program's place, computed in the precision below
the configuration's (fp8 below bf16, TF32 below fp32 with TF32 off), or
fed half of each batch.  Their readings are the limits' upper ends
(PERF.md); the benchmark's own runs never run them."""
from __future__ import annotations

from typing import Dict

import torch

from ..harness.traffic import StreamTraffic, train_batches
from ..reference import nets, stream as rs
from ..reference.precision import FP8, set_quant, tf32
from ..reference.train import joint_loss
from ..reference.weights import seeded_state
from . import stream as cs
from . import train as ct


class Cast(torch.nn.Module):
    """A module called on copies of its floating weights cast to `dtype`
    (the gradients reach the fp32 weights through the casts), as the
    program computes in bf16 over fp32 masters."""

    def __init__(self, module: torch.nn.Module, dtype: torch.dtype):
        super().__init__()
        self.module, self.dtype = module, dtype

    def _state(self):
        return {n: t.to(self.dtype) if t.is_floating_point() else t
                for n, t in list(self.module.named_parameters())
                + list(self.module.named_buffers())}

    def forward(self, *args, **kwargs):
        return torch.func.functional_call(self.module, self._state(), args, kwargs)

    def memorize(self, *args, **kwargs):
        return self("memorize", *args, **kwargs)

    def segment(self, *args, **kwargs):
        return self("segment", *args, **kwargs)


def _reference(cell, seed: int, device):
    """The reference networks on `device` with the run's seeded weights, and
    those weights."""
    ref = nets.build(cell.config["network"], cell.config.get("model_scale", 1))
    states = {}
    for j, (k, m) in enumerate(ref.items()):
        states[k] = seeded_state(m.to("meta"), seed + j, device)
        m.load_state_dict(states[k], assign=True)
        m.to(device)
    return ref, states


def stream_readings(cell, seed: int, device, lower: bool = True) -> Dict[str, float]:
    """One clip of the cell's traffic served by the reference in the
    program's place (in the precision below when `lower`), judged as the
    benchmark judges a served clip."""
    from ..runners.stream import drawn_frames, judged_frames

    joint = cell.config["network"] == "joint"
    bf16 = cell.traffic["dtype"] == "bf16"
    ref, _ = _reference(cell, seed, device)
    frames, tri = StreamTraffic(cell.traffic, seed, device).clip(0)
    n, (h, w) = len(frames), frames[0].shape[:2]
    need = judged_frames(n, h, w, joint, cell.traffic, seed)
    served = dict(ref)
    if lower and bf16:
        served = {k: Cast(m, torch.bfloat16) for k, m in ref.items()}
        set_quant(ref, FP8)
    with tf32(lower and not bf16):
        alphas, trimaps, bank = rs.run_clip(served, frames, tri, device,
                                            torch.bfloat16 if bf16 and lower else torch.float32,
                                            joint)
    set_quant(ref, None)
    with tf32(False):
        if joint:
            got = {i: (alphas[i], trimaps[i]) for i in need}
            return cs.check_joint(ref, frames, tri, got, bank.stacked(), device)
        return cs.check_trimap(ref, frames, tri, {i: trimaps[i] for i in need},
                               drawn_frames(n, cell.traffic, seed), device)


def train_readings(cell, seed: int, device, fault: str = "lower") -> Dict[str, float]:
    """The train check's numbers for the reference in the program's place,
    in the program's precision: `lower` in the precision below, `half_batch`
    on the first half of each batch's rows (the mean over the rest),
    `exchange` on rank 0's rows alone (a step of `chips` ranks whose
    gradients are never exchanged)."""
    t = cell.traffic
    batches = train_batches(t, seed)[:t["check_steps"]]
    ref, states = _reference(cell, seed, device)
    bf16 = t["dtype"] == "bf16"
    with tf32(False):
        want = ct.reference_readings(cell, states, batches, device)
    model, dtype, rows = ref, None, None
    if bf16:
        model, dtype = {k: Cast(m, torch.bfloat16) for k, m in ref.items()}, torch.bfloat16
    if fault == "lower" and bf16:
        set_quant(ref, FP8)
    elif fault != "lower":
        rows = slice(0, t["batch"] // (2 if fault == "half_batch" else cell.chips))
    with tf32(fault == "lower" and not bf16):
        got = ct.reference_readings(cell, states, batches, device, dtype=dtype, rows=rows,
                                    model=model)
    return ct.compare(got, want)


def newest_slot_dropped():
    """A fault that only replayed frames meet: the port's read leaves out
    the bank's newest valid slot wherever the bank holds more than one
    (frame 0 runs eagerly and reads nothing).  Planted before the evaluator
    is built, so that its graphs capture it.  Returns the undo."""
    from otvm_tpu_torch.models import stm

    read = stm.memory_read

    def dropped(q_k, m_k, m_v, slot_mask=None, impl=None):
        if slot_mask is not None:
            valid = slot_mask.sum(1, keepdim=True)
            newest = torch.arange(slot_mask.shape[1], device=slot_mask.device) == valid - 1
            slot_mask = slot_mask & ~(newest & (valid > 1))
        return read(q_k, m_k, m_v, slot_mask, impl=impl)

    stm.memory_read = dropped
    return lambda: setattr(stm, "memory_read", read)


def replayed_alpha_altered():
    """A fault that only replayed frames meet: the joint step's alpha
    comes out mirrored top to bottom on every frame but a clip's first,
    after the bank took it as it was.  Planted where the evaluator (CPU)
    and its graphs (CUDA) find the step, before the evaluator is built.
    Returns the undo."""
    from otvm_tpu_torch.eval import runner
    from otvm_tpu_torch.models import graphs
    from otvm_tpu_torch.models.otvm import EvalOutput

    step = graphs.eval_frame_step

    def altered(*a, **k):
        out = step(*a, **k)
        first = a[5] if len(a) > 5 else k["first_frame"]
        return out if first else EvalOutput(out.bank, out.alpha.flip(1), out.trimap)

    graphs.eval_frame_step = runner.eval_frame_step = altered

    def undo():
        graphs.eval_frame_step = runner.eval_frame_step = step
    return undo
