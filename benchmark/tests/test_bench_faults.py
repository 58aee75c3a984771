"""A run with the timed path broken underneath comes out not correct: the
harness's runners, on the CPU at model scale 4 and tiny sizes (the look
for a chip skipped), in fp32, with the port patched at the fault.  A sound
run under the same limits comes out correct."""
import time

import pytest
import torch

from benchmark.harness import cells
from benchmark.tests.conftest import shrink

TRAIN = "s4-train-320-fp32-4chip"
# the numbers each cell compares (benchmark/limits/), at limits for fp32 on
# the CPU, where the port and the reference agree to rounding (~1e-6)
LIMITS = {"s4-stream-1088x1920-bf16": {"first_slot_rel": 1e-3, "replay_slot_rel": 1e-3},
          "trimap-stream-1088x1920-fp32": {"trimap_mae": 1e-3},
          TRAIN: {"grad_gap": 1e-2, "change_gap": 5e-2}}


def _run(tmp_path, name):
    cell = shrink(tmp_path, name, limits=LIMITS[name], chips=1)
    cell.traffic["dtype"] = "fp32"
    return cells.runner(cell).run(cell, seed=2 ** 31 + 17, seconds=0.0, trace=False,
                                  t_start=time.time(), device="cpu")


def _state_unchanged(monkeypatch):
    from otvm_tpu_torch.models import otvm

    monkeypatch.setattr(otvm, "update_bank", lambda bank, *a, **k: bank)


def _answer_altered(monkeypatch):
    from otvm_tpu_torch.eval import runner
    from otvm_tpu_torch.models.otvm import EvalOutput

    step, tstep = runner.eval_frame_step, runner.trimap_eval_step

    def altered(*a, **k):
        out = step(*a, **k)
        return EvalOutput(out.bank, 1.0 - out.alpha, out.trimap)

    def altered_trimap(*a, **k):
        bank, pred = tstep(*a, **k)
        return bank, pred.flip(-1)

    monkeypatch.setattr(runner, "eval_frame_step", altered)
    monkeypatch.setattr(runner, "trimap_eval_step", altered_trimap)


def _newest_slot_dropped(monkeypatch):
    from otvm_tpu_torch.models import stm

    from benchmark.checks import control

    monkeypatch.setattr(stm, "memory_read", stm.memory_read)     # restored after the test
    control.newest_slot_dropped()


def _replayed_alpha_altered(monkeypatch):
    from otvm_tpu_torch.eval import runner
    from otvm_tpu_torch.models import graphs

    from benchmark.checks import control

    monkeypatch.setattr(runner, "eval_frame_step", runner.eval_frame_step)
    monkeypatch.setattr(graphs, "eval_frame_step", graphs.eval_frame_step)
    control.replayed_alpha_altered()


def _optimizer_idle(monkeypatch):
    from otvm_tpu_torch.train.optim import RAdam

    monkeypatch.setattr(RAdam, "update", lambda self: [])


def _half_batch(monkeypatch):
    from otvm_tpu_torch.train import trainer

    forward = trainer.joint_train_forward

    def half(stm, fba, batch, *a, **k):
        rows = batch["fg"].shape[0] // 2
        return forward(stm, fba, {key: v[:rows] for key, v in batch.items()}, *a, **k)

    monkeypatch.setattr(trainer, "joint_train_forward", half)


def _loss_altered(monkeypatch):
    from otvm_tpu_torch.train import trainer

    forward = trainer.joint_train_forward

    def altered(*a, **k):
        total, aux = forward(*a, **k)
        return total * 1.5, aux

    monkeypatch.setattr(trainer, "joint_train_forward", altered)


STREAMS = ["s4-stream-1088x1920-bf16", "trimap-stream-1088x1920-fp32"]


@pytest.mark.parametrize("name", STREAMS + [TRAIN])
def test_sound_run_is_correct(tmp_path, eager_bank, name):
    out = _run(tmp_path, name)
    assert out["correct"], out["compared"]


@pytest.mark.parametrize("fault", [_state_unchanged, _answer_altered, _newest_slot_dropped])
@pytest.mark.parametrize("name", STREAMS)
def test_stream_fault_is_caught(tmp_path, monkeypatch, eager_bank, name, fault):
    fault(monkeypatch)
    out = _run(tmp_path, name)
    assert not out["correct"], out["compared"]


def test_replayed_alpha_altered_is_caught(tmp_path, monkeypatch, eager_bank):
    _replayed_alpha_altered(monkeypatch)
    out = _run(tmp_path, STREAMS[0])
    assert not out["correct"], out["compared"]
    assert out["stats"]["first_slot_rel"] <= LIMITS[STREAMS[0]]["first_slot_rel"], out["stats"]


@pytest.mark.parametrize("fault", [_optimizer_idle, _half_batch, _loss_altered])
def test_train_fault_is_caught(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(tmp_path, TRAIN)
    assert not out["correct"], out["compared"]


def _rank_without_exchange(*args):
    """A rank whose gradients are never exchanged with the others'."""
    from otvm_tpu_torch.parallel import dist

    from benchmark.runners import train

    dist.all_reduce_gradients = lambda *a, **k: None
    return train.rank_main(*args)


def test_exchange_left_out_is_caught(tmp_path):
    """Four gloo ranks on the CPU, each taking its row of the global batch."""
    from otvm_tpu_torch.parallel import dist

    cell = shrink(tmp_path, TRAIN, chips=4, limits=dict(LIMITS[TRAIN], ranks_differ=0.0))
    cell.traffic.update(dtype="fp32", batch=4)
    args = (cell, 2 ** 31 + 17, 0.0, False, time.time(), "cpu")
    sound = dist.spawn(__import__("benchmark.runners.train", fromlist=["x"]).rank_main, 4,
                       *args, timeout=600)[0]
    assert sound["correct"], sound["compared"]
    broken = dist.spawn(_rank_without_exchange, 4, *args, timeout=600)[0]
    assert not broken["correct"], broken["compared"]
