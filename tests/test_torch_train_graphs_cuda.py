"""The train steps from CUDA graphs (otvm_tpu_torch/train/graphs.py) on a
CUDA card, against the eager steps, at scale 4 and at full width on 64x64
crops (B 2, S 3), through tools/train_graphs_check.py, under torch's
deterministic algorithms (there two eager steps from one state agree bit
for bit, which each step checks):

  * graphed equals eager bit for bit step by step (`lockstep`: each
    graphed step beside two eager steps from the same state; its loss,
    gradients, change to the parameters and RAdam's moments) at stages
    1-4 in fp32, stage 4 in bf16 and with remat, and trimap-s1, over 8
    steps across RAdam's hold (steps 1-5); 12 steps at stage 4 cross a
    stair drop (step 10 of 10);
  * one capture a run; the reads counted at every replay (2 a step, 4 with
    remat), merged as launch_geometry says;
  * the metrics kept across steps are not aliased to the graph's pool;
  * the frozen-scalar controls are rejected: FrozenScalarRAdam (the
    capture's step size and decay at every replay) captured in the hold
    and before the stair drop, FrozenDecayRAdam (the decay alone, a small
    error) before the drop;
  * restore_train_state between two replays gives the eager run's next
    steps from the same file, on the same graph;
  * a step under a lockstep check, and a state whose moments were replaced,
    raise;
  * a state with a one-rank NCCL group (tools/ddp_check.py run_graphed):
    its graph holds NCCL's collectives (GlobalSum's and the gradient
    all-reduce), bit for bit with the eager step at every step of fp32
    stage 4 over 8 steps, remat, bf16 and trimap-s1, with the reads
    counted at every replay.

Needs a card and no JAX:
`python -m pytest --noconftest -m cuda tests/test_torch_train_graphs_cuda.py`."""
import os

# torch's deterministic mode asks this of cuBLAS before its first call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from otvm_tpu_torch import config  # noqa: E402
from otvm_tpu_torch.tools import train_graphs_check as C  # noqa: E402
from otvm_tpu_torch.tools.kernel_check import lockstep_check  # noqa: E402
from otvm_tpu_torch.tools.profile_train import seeded_batches  # noqa: E402
from otvm_tpu_torch.train import trainer as T  # noqa: E402
from otvm_tpu_torch.utils.checkpoint import save_train_state  # noqa: E402

HW, B, S, STEPS = 64, 2, 3, 12
SCALES = [pytest.param(4, id="scale4"), pytest.param(1, id="full")]
STAIR = C.Case("fp32 stage 4, stair over 10", STEPS, stair_iters=10)
CASES = [STAIR,
         C.Case("bf16 stage 4", 8, bf16=True),
         C.Case("fp32 stage 4, remat", 8, remat=True),
         C.Case("fp32 stage 3", 8, stage=3),
         C.Case("fp32 stage 2", 8, stage=2),
         C.Case("fp32 stage 1", 8, stage=1),
         C.Case("trimap-s1", 8, stage=1, trimap=True)]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _cfg(scale):
    cfg = config.get_cfg_defaults()
    cfg.model_scale = scale
    cfg.train.train_input_size, cfg.train.batch_size, cfg.train.frame_num = (HW, HW), B, S
    return cfg


_nets = {}


def _setup(scale, stage):
    """(cfg, the stage's networks of seed 0, 12 seeded batches), made once."""
    _cuda()
    cfg = _cfg(scale)
    if (scale, stage) not in _nets:
        cfg.train.stage = stage
        _nets[scale, stage] = C.Nets(cfg, seed=0, device="cuda")
    return cfg, _nets[scale, stage], seeded_batches(cfg, STEPS, seed=1)


def _check_lockstep(case, cfg, result, summary):
    assert not C.verify(result), summary
    assert result["captures"] == 1
    reads, merges = case.reads_per_step(cfg), case.merges_per_step(cfg)
    for launches, merged, n in (
            (result["graphed_launches"], result["graphed_merges"], case.steps),
            (result["launches"], result["merges"], case.steps * (C.EAGER_RUNS + 1))):
        assert launches == reads * n and merged == tuple(x * n for x in merges), summary


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
@pytest.mark.parametrize("scale", SCALES)
def test_graphed_steps_equal_eager(scale, case):
    cfg, nets, batches = _setup(scale, case.stage)
    result = C.check_case(case, cfg, nets, batches, control=case is STAIR, timing=False)
    summary = C.summary(case, result)
    print(summary)
    _check_lockstep(case, case.config(cfg), result["lockstep"], summary)
    if case is STAIR:
        # captured at step 2, the control's step size stays RAdam's held 0
        assert any("delta of step 6" in f for f in result["control_failures"])


@pytest.mark.cuda
@pytest.mark.parametrize("scale", SCALES)
def test_a_learning_rate_frozen_before_the_stair_drop_is_rejected(scale):
    """7 eager steps, then graphed ones: the capture at step 9 comes before
    the drop at step 10.  RAdam passes; each frozen control keeps the
    undropped learning rate from step 10 on, in its step size and decay or
    in its decay alone."""
    cfg, nets, batches = _setup(scale, 4)
    late = C.lockstep(STAIR, cfg, nets, batches, eager_first=7)
    assert not C.verify(late), C.verify(late)
    assert late["captures"] == 1
    for control in (C.FrozenScalarRAdam, C.FrozenDecayRAdam):
        frozen = C.lockstep(STAIR, cfg, nets, batches, eager_first=7, optimizer=control)
        failures = C.verify(frozen)
        print(control.__name__, failures)
        assert frozen["captures"] == 1
        assert [f"delta of step {i}:" in " ".join(failures) for i in range(1, 13)] == \
            [False] * 9 + [True] * 3


@pytest.mark.cuda
@pytest.mark.parametrize("scale", SCALES)
def test_restore_between_replays_continues_as_eager(scale, tmp_path):
    """An eager run saved after step 7, restored into the graphed run after
    its step 3 (between two replays of one graph): its next 5 steps equal
    eager steps from the restored state."""
    cfg, nets, batches = _setup(scale, 4)
    case = C.Case("fp32 stage 4, restored", 8, stair_iters=10)
    run_cfg = case.config(cfg)
    state = nets.fresh(run_cfg, C.RAdam)
    step = T.make_train_step(run_cfg, graphs=False)
    for batch in batches[:7]:
        state, _ = step(state, batch)
    path = str(tmp_path / "step7.pt")
    save_train_state(path, state)
    del state, step
    graphed = C.lockstep(case, cfg, nets, batches, restore=(3, path))
    assert not C.verify(graphed), C.verify(graphed)
    assert graphed["captures"] == 1
    assert [s["held"] for s in graphed["steps"]] == [True] * 3 + [None] * 5


@pytest.mark.cuda
def test_lockstep_and_replaced_moments_are_refused():
    cfg, nets, batches = _setup(4, 4)
    cfg.train.stage = 4
    state = nets.fresh(cfg, C.RAdam)
    step = T.make_train_step(cfg)
    state, _ = step(state, batches[0])                      # the warm-up
    with lockstep_check(torch.float32), pytest.raises(RuntimeError, match="lockstep"):
        step(state, batches[1])
    assert state.step == state.optimizer.param_groups[0]["step"] == 1
    state, _ = step(state, batches[1])                      # captured and replayed
    state, _ = step(state, batches[2])
    with lockstep_check(torch.float32), pytest.raises(RuntimeError, match="lockstep"):
        step(state, batches[3])
    opt = state.optimizer
    p = opt.param_groups[0]["params"][0]
    opt.state[p] = {k: v.clone() for k, v in opt.state[p].items()}
    with pytest.raises(RuntimeError, match="not the tensors"):
        step(state, batches[3])
    assert state.step == 3 and np.isfinite(step.graphs.capture_s)
    opt.zero_grad(set_to_none=True)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", SCALES)
def test_a_one_rank_nccl_group_replays_its_collectives(scale):
    """tools/ddp_check.py run_graphed at world 1: a one-rank NCCL group,
    spawned (its collectives are NCCL's, captured and replayed), global
    batch 4 at 64x64, S 3."""
    _cuda()
    from otvm_tpu_torch.tools import ddp_check

    results = ddp_check.run_graphed(1, scale=scale, size=HW, frames=S, timing=0,
                                    timeout=600)
    print(ddp_check.summary_graphed(results))
    ddp_check.verify_graphed(results)
    assert results[0]["backend"] == "nccl" and results[0]["device"] == "cuda:0"
    assert [c["lockstep"]["graphed_launches"] for c in results[0]["cases"].values()] == \
        [2 * 8, 4 * 3, 2 * 3, 2 * 3]
