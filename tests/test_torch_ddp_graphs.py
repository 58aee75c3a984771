"""What the data-parallel train step needs to run from CUDA graphs
(otvm_tpu_torch/parallel/dist.py, train/graphs.py), on the CPU: 2 gloo
ranks, spawned, one thread each, under a time limit of their own (a rank
waiting on a collective that the other never issues would wait for ever).

  * the gradient all-reduce as a plan made on the host and a device part
    (`plan_gradients`, `reduce_gradients`, and `all_reduce_gradients` made
    of them) equals the function before the split bit for bit
    (tests/ddp_workers.py), with a parameter that one rank lacks (zeros
    there) and one that every rank lacks (.grad stays None);
  * `GradientPlans` makes a key's plan once and reuses it, and a step that
    contradicts it (a gradient that no rank held) raises;
  * ranks whose step keys differ raise, every one of them;
  * `refusal` refuses a CPU state and a gloo group, each with its reason,
    and accepts an NCCL group (a stand-in for the backend's name).
The graphed step over NCCL itself runs on cards:
tests/test_torch_ddp_cuda.py, tests/test_torch_train_graphs_cuda.py."""
import types

import pytest
import torch

from otvm_tpu_torch.parallel import dist as D
from otvm_tpu_torch.train import graphs
from tests import ddp_workers

SPAWN_TIMEOUT = 120


@pytest.fixture(scope="module")
def ranks():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)            # a thread a rank
    try:
        return D.spawn(ddp_workers.gradient_plan_rank, 2, timeout=SPAWN_TIMEOUT)
    finally:
        torch.set_num_threads(threads)


def test_plan_and_device_part_equal_the_unsplit_all_reduce(ranks):
    for r in ranks:
        assert r["same"] == [True] * 3
        assert r["held"] == (True, True, True, True, False, True, True)
        assert r["none"] == [False] * 4 + [True, False, False]
        # 40 bytes a bucket: 48 alone, then 20 + 16 + 28; the fp64 parameter
        # between two fp32 ones makes a bucket of its own
        assert r["world"] == 2 and r["buckets"] == ((0,), (1, 2, 3), (5,), (6,))
    assert ranks[0]["grad"] == ranks[1]["grad"]


def test_a_plan_is_made_once_a_key_and_a_contradiction_raises(ranks):
    for r in ranks:
        assert r["made"] == 1 and r["reused"] and r["planned_same"] == [True] * 3
        assert r["contradiction"] and "no rank holds" in r["contradiction"]


def test_keys_that_differ_across_ranks_raise_on_every_rank(ranks):
    for r in ranks:
        assert r["keys"] and "differ in their keys" in r["keys"]


def test_refusal_takes_nccl_and_refuses_the_cpu_and_gloo(monkeypatch):
    cpu = types.SimpleNamespace(device=torch.device("cpu"), group=None)
    assert "CPU" in graphs.refusal(cpu)
    card = types.SimpleNamespace(device=torch.device("cuda", 0), group=object())
    monkeypatch.setattr(D, "group_backend", lambda group: "gloo")
    why = graphs.refusal(card)
    assert "gloo" in why and "cannot be captured" in why
    monkeypatch.setattr(D, "group_backend", lambda group: "nccl")
    assert graphs.refusal(card) is None
    assert graphs.refusal(types.SimpleNamespace(device=torch.device("cuda", 0), group=None)) \
        is None
