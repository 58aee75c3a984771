"""Data parallelism over NCCL, one card a rank (otvm_tpu_torch/parallel/
dist.py, tools/ddp_check.py, the training CLI under torchrun).  Needs 2
cards (4 for the 4-rank case) and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_ddp_cuda.py

  * 2 and 4 ranks take ddp_check.CARD_LINES at full width and config.py's
    crop and global batch (320x320, 4: 2 and 1 a rank, S 3): fp32 stage 4
    with a remat step among the first 6 and every read (forward, the remat
    re-run, backward) in lockstep with the plain read in every rank, the
    ranks bit-equal after every step, held to rank 0's 1-process run of the
    same steps within the bounds ddp_check.verify sets (at full width the
    1-process step itself moves by its measured spread); 3 timed steps and
    a profiled one (the all-reduce's NCCL kernels), a bf16 step; a stage-1
    and a trimap-s1 step.  Each case's
    numbers go to the junit properties (--junitxml=...).
  * 2 and 4 ranks replay the train step from CUDA graphs with their NCCL
    collectives captured (ddp_check.run_graphed, GRAPHED_CASES at full
    width): every graphed step bit for bit with the eager step from the
    same state under torch's deterministic algorithms, the ranks bit-equal
    after every step, the reads counted at every replay.  At 4 ranks NCCL's
    algorithm and protocol are pinned (ddp_check.PINNED) for that check,
    and an unpinned run of the fp32 case is held to eager within
    ddp_check.GRAPHED_TOL and timed beside it.
  * torchrun --nproc_per_node 2 of the stage-4 training CLI on
    scripts/make_synth_data.py's data, graphed (its default): one
    checkpoint and one log, rank 0's, whose step line says so.
"""
import json
import os

# the graphed check's deterministic mode asks this of cuBLAS before its
# first call (the ranks are spawned with this environment)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _need_cards(n):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards")


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [2, 4])
def test_nccl_ranks_take_the_one_process_step(ranks, record_property):
    _need_cards(ranks)
    from otvm_tpu_torch.tools import ddp_check

    results = ddp_check.run(ranks)
    summary = ddp_check.summary(results)
    print(summary)
    record_property("summary", summary)
    record_property("results", json.dumps(results))
    ddp_check.verify(results)      # reads and lockstep checks a step, and the bounds
    assert [r["device"] for r in results] == [f"cuda:{i}" for i in range(ranks)]
    assert all(r["backend"] == "nccl" for r in results)
    assert results[0]["compare"]["stage4"]["params_moved"]
    assert results[0]["lines"]["stage4"]["profiled"]["nccl_ms"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [2, 4])
def test_nccl_ranks_replay_the_graphed_step_as_eager(ranks, record_property):
    _need_cards(ranks)
    from otvm_tpu_torch.tools import ddp_check

    runs = {}
    if ranks > 2:
        runs["pinned"] = ddp_check.run_graphed(ranks, pinned=True, timeout=1200)
    runs["unpinned"] = ddp_check.run_graphed(
        ranks, cases=ddp_check.GRAPHED_CASES[:1] if runs else ddp_check.GRAPHED_CASES,
        timeout=1200)
    for name, results in runs.items():
        summary = ddp_check.summary_graphed(results)
        print(summary)
        record_property(f"{name} summary", summary)
        record_property(f"{name} results", json.dumps(results))
    for name, results in runs.items():
        ddp_check.verify_graphed(results, exact=name == "pinned" or ranks == 2)
        assert [r["device"] for r in results] == [f"cuda:{i}" for i in range(ranks)]
        assert all(r["backend"] == "nccl" for r in results)
        assert results[0]["cases"]["fp32 stage 4"]["profiled"]["graphed"]["nccl_ms"] > 0


@pytest.mark.cuda
def test_torchrun_training_cli(tmp_path):
    _need_cards(2)
    data = tmp_path / "data"
    subprocess.run([sys.executable, os.path.join(REPO, "scripts", "make_synth_data.py"),
                    str(data), "--n-train", "8", "--n-val", "2", "--frames", "12",
                    "--dim-fg", "8", "--dim-bg", "8"], check=True, timeout=300)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
         "--master_port", "29531", "-m", "otvm_tpu_torch.cli.train", "--stage", "4",
         "--data-root", str(data), "--testmode", "--repeats", "1", "--workers", "2"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=900)
    print(proc.stdout[-4000:], proc.stderr[-4000:])
    assert proc.returncode == 0
    assert os.listdir(tmp_path / "weights") == ["s4_OTVM"]
    run_dir = tmp_path / "train_log" / "s4_OTVM"
    logs = [f for f in os.listdir(run_dir) if f.endswith(".log")]
    assert len(logs) == 1 and {"config.yaml", "ckpt_e1"} <= set(os.listdir(run_dir))
    text = (run_dir / logs[0]).read_text()
    assert text.count(" I0 ") == 1 and "ranks 2" in text
    assert "one CUDA-graph replay a step on each of 2 nccl ranks" in text
    ckpt = torch.load(tmp_path / "weights" / "s4_OTVM", map_location="cpu", weights_only=True)
    assert ckpt["step"] == 2 and not any(k.startswith("module.") for k in ckpt["stm"])
