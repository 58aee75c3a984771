"""Data parallelism in the port (otvm_tpu_torch/parallel/dist.py, the
trainer's process group, the training CLIs under N ranks) on the CPU: 2
gloo ranks, each one process on one thread, take the step that one process
takes on the global batch (tests/test_torch_ddp_jax.py holds step 1 to the
JAX package's data-mesh step).

Scale-4 models, 64x64 crops, S 2, global batch 4 (2 a rank).  The global
batch's rows differ in contrast (tools/ddp_check.py global_batches), so a
rank's own exclusion-loss ratio differs from the global batch's one.

  * Losses: the ranks' mean within 1e-5 (relative) of the 1-process loss
    (LOSS_RTOL; measured ~1e-7).
  * RAdam's moments after 3 steps (the mean gradients: RAdam moves no
    parameter before step 6) and the parameters: norm-relative per network
    within 1e-4 (STATE_TOL; fp32 summation order, measured ~1e-5), and
    every rank bit-equal to every other after every step.
"""
import os

import numpy as np
import pytest
import torch

from otvm_tpu_torch.cli import train as cli_train
from otvm_tpu_torch.config import get_cfg_defaults
from otvm_tpu_torch.data.datasets import DIMTrain, VM108Train, vm108_max_skip_for_epoch
from otvm_tpu_torch.data.loader import Loader, encode_wire, epoch_indices
from otvm_tpu_torch.parallel import dist as D
from otvm_tpu_torch.tools import ddp_check as C
from otvm_tpu_torch.utils import trace
from tests import ddp_workers
from tests.torch_port import one_thread, write_train_tree  # noqa: F401

SCALE, HW, S = 4, 64, 2
LINES = {name: C.Line(name, stage, ("checked",) * 3, state_at=3, trimap=name == "trimap_s1",
                     moments_at=3)
         for name, stage in (("stage4", 4), ("stage2", 2), ("stage1", 1), ("trimap_s1", 1))}


@pytest.fixture(scope="module")
def two_ranks_traced():
    """The lines on 2 ranks, a thread each (spawn shares this process's
    threads among them; the module's tests run before one_thread sets it),
    with spans on (utils/trace.py): (each rank's result, the records that
    spawn brought back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.reset()
    trace.enable()
    try:
        results = C.run(2, "cpu", lines=tuple(LINES.values()), scale=SCALE, size=HW, frames=S)
        return results, trace.take()
    finally:
        trace.disable()
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def two_ranks(two_ranks_traced):
    return two_ranks_traced[0]


@pytest.mark.parametrize("name", list(LINES))
def test_two_ranks_take_the_one_process_step(two_ranks, name):
    for r in two_ranks:
        assert r["backend"] == "gloo"
        assert [s["ranks_equal"] for s in r["lines"][name]["step"]] == [True] * 3
    assert [s["loss"] for s in two_ranks[0]["lines"][name]["step"]] == \
        [s["loss"] for s in two_ranks[1]["lines"][name]["step"]]
    cmp = two_ranks[0]["compare"][name]
    C.verify([dict(two_ranks[0], compare={name: cmp})])
    # the rows differ: each rank's own loss is not the global one
    assert two_ranks[0]["lines"][name]["step"][0]["rank_loss"] != \
        two_ranks[1]["lines"][name]["step"][0]["rank_loss"]
    assert not cmp["params_moved"] and max(cmp["moments_at"].values()) > 0
    if name == "stage1":            # the STM takes no gradient: its moments stay zero
        assert cmp["moments_at"]["stm"] == 0.0 and cmp["exp_avg"]["stm"] == 0.0
    if name == "stage2":            # the frozen STM is not in the optimizer
        assert set(cmp["exp_avg"]) == {"fba"}


def test_both_ranks_spans_reach_the_parent(two_ranks_traced):
    """Each rank's train steps, recorded in its own process, come back
    through spawn tagged with its rank (rank 0 takes the one-process steps
    it is compared with as well); nothing else is recorded here."""
    _, records = two_ranks_traced
    steps = {0: [], 1: []}
    for r in records:
        if r.name == "train.step":
            steps[r.rank].append(r)
            assert r.ids["rank"] == r.rank
    assert len(steps[0]) > len(steps[1]) > 0
    for rank, spans in steps.items():
        counted = sum(r.n for r in records if r.name == "train.steps" and r.rank == rank)
        assert counted == len(spans)
        ids = {r.id for r in spans}
        uploads = [r for r in records if r.name == "train.upload" and r.rank == rank
                   and r.parent in ids]
        assert len(uploads) == len(spans)
    assert trace.records() == []


def test_local_exclusion_ratio_fails_the_check():
    """Mutation: each rank scales by its own rows' exclusion ratio."""
    line = C.Line("stage4", 4, ("checked",), state_at=1, moments_at=1)
    results = D.spawn(ddp_workers.local_exclusion_rank, 2, "cpu", None, (line,), SCALE, HW, S, 0)
    with pytest.raises(AssertionError, match="loss"):
        C.verify(results)


def _cfg():
    cfg = get_cfg_defaults()
    cfg.train.stage, cfg.model_scale, cfg.train.frame_num = 4, SCALE, S
    cfg.train.train_input_size = (HW, HW)
    return cfg


def test_training_clis_on_two_ranks(tmp_path, monkeypatch):
    """Both training CLIs as 2 gloo ranks (global batch 4): each rank's
    Loader strided by rank, 2 rows a step; one run directory, config.yaml,
    log and checkpoint, rank 0's; the logged loss the mean of the ranks'.
    The 2-rank checkpoint then resumes in one process."""
    root = write_train_tree(tmp_path / "data", 96, 128)
    common = ["--device", "cpu", "--testmode", "--data-root", root, "--input-size", str(HW),
              "--batch-size", "4", "--repeats", "2", "--workers", "1"]
    work = tmp_path / "work"
    work.mkdir()
    argvs = (("train", common + ["--stage", "4"]), ("train_s1_trimap", common))
    ranks = D.spawn(ddp_workers.cli_rank, 2, str(work), root, SCALE, argvs)

    cfg = get_cfg_defaults()                    # the CLIs' clip length and seed
    seed, frames = cfg.system.random_seed, cfg.train.frame_num
    datasets = (VM108Train(root, (HW, HW), frames),
                DIMTrain.from_adobe_layout(root, image_shape=(HW, HW), sample_length=frames))
    datasets[0].max_skip = vm108_max_skip_for_epoch(0, cfg.train.total_epochs)
    for run, dataset in enumerate(datasets):
        (res0, log0), (res1, log1) = ranks[0][run], ranks[1][run]
        assert res0["step"] == res1["step"] == 1
        strided = [epoch_indices(len(dataset), 0, 2, seed, r, 2) for r in (0, 1)]
        assert sorted(np.concatenate(strided)) == sorted(epoch_indices(len(dataset), 0, 2, seed))
        for r, log in enumerate((log0, log1)):
            assert log["loaders"] == [(strided[r].tolist(), 2)]
            first = encode_wire(next(iter(Loader(dataset, strided[r], 2, seed=seed))))
            assert log["batches"][0]["fg"].shape[0] == 2
            for k, v in log["batches"][0].items():
                np.testing.assert_array_equal(v, first[k], err_msg=k)
        logged = res0["losses"][0]
        assert res1["losses"][0] == logged
        np.testing.assert_allclose(logged, np.mean([log0["losses"][0], log1["losses"][0]]),
                                   rtol=1e-6)
        assert res1["run_dir"] is None
    for name in ("s4_OTVM", "s1_OTVM_trimap"):
        files = os.listdir(work / "train_log" / name)
        logs = [f for f in files if f.endswith(".log")]
        assert len(logs) == 1, files
        assert (work / "train_log" / name / logs[0]).read_text().count(" I0 ") == 1
    assert {"config.yaml", "ckpt_e1"} <= set(os.listdir(work / ranks[0][0][0]["run_dir"]))
    assert sorted(os.listdir(work / "weights")) == ["s1_OTVM_trimap", "s4_OTVM"]

    monkeypatch.chdir(work)
    monkeypatch.setattr(cli_train, "get_cfg_defaults", lambda: _cfg())
    again = cli_train.main(common + ["--stage", "4", "--resume", "weights/s4_OTVM"])
    assert again["start_epoch"] == 1 and again["state"].step == 1 and again["losses"] == []


def test_collectives_on_two_ranks():
    """batch_means over both ranks' rows; GlobalSum's backward hands each
    rank the sum over ranks of their losses' gradients (losses 1x and 2x the
    global mean: (1 + 2) / 6 at every element of both ranks' x), which
    all_reduce_gradients' mean over ranks turns into the gradient of the
    ranks' mean loss.  all_reduce_gradients averages in buckets, counts a
    gradient a rank lacks as zero and leaves one no rank has as None."""
    for r in D.spawn(ddp_workers.collectives_rank, 2):
        assert r["mean"] == 3.0
        assert r["grad"] == [0.5] * 3
        assert r["p"] == [3.0, 3.0] and r["q"] == [2.0, 2.0] and r["r"] is None
        assert r["rows"] == [[1.0, 2.0, 3.0], [2.0, 4.0, 6.0]] and r["mean_of"] == [1.5, 3.0, 4.5]
        assert not r["equal_x"] and r["equal_ones"]


def test_one_process_needs_no_group(monkeypatch):
    """Without WORLD_SIZE the port joins nothing; the reductions are the
    tensors themselves; WORLD_SIZE > 1 without the rendezvous raises."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert D.init_distributed("cpu") == torch.device("cpu")
    assert (D.process_index(), D.process_count(), D.data_group()) == (0, 1, None)
    x = torch.tensor([1.5, 2.0])
    assert torch.equal(D.all_reduce_mean([x])[0], x) and torch.equal(D.all_gather_rows(x), x[None])
    assert [m.item() for m in D.batch_means([x, 2 * x])] == [1.75, 3.5]
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    for key in ("LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="without LOCAL_RANK, MASTER_ADDR, MASTER_PORT"):
        D.init_distributed("cpu")
