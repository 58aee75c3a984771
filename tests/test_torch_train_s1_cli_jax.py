"""The port's trimap-s1 CLI (otvm_tpu_torch/cli/train_s1_trimap.py) held
against the JAX package's train_s1_trimap.py, each run in this process
through its main() with the same argv on the same data tree and the same
`--init STM_weights.pth`, which both packages' importers read; fp32 on the
CPU.

As tests/test_torch_train_cli_jax.py: each batch as the step receives it
must be equal, and so must the losses, the logged ones, the steps taken
(`--max-iters` included) and the checkpoints saved; then the in-training
IoU's labels.  Full width (the JAX trimap forward builds only the
full-width STM), 32x32 crops, B 2, two epochs of one step each (two
batches an epoch, cut to one by `--max-iters 1`).  The losses: rtol 1e-5,
as there.  Trimap labels: the
GT's equal, the prediction's agree at 99% of pixels or more, as
tests/test_torch_train_forward.py's (random weights leave pixels where
two classes tie within fp32 noise).
"""
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("cv2")

import otvm_tpu.eval.metrics as jmetrics
import otvm_tpu.train.trainer as jtrainer
from otvm_tpu_torch.cli import train_s1_trimap as cli_s1
from otvm_tpu_torch.models.otvm import init_models

from tests.torch_port import (assert_same_training, one_thread,  # noqa: F401
                              record_ious, record_steps, run_jax_cli, run_port_cli,
                              write_train_tree)

LOSS_RTOL = 1e-5


def test_train_s1_trimap_cli_matches_jax(tmp_path, monkeypatch):
    data_root = write_train_tree(tmp_path / "data", 96, 128)
    stm, _ = init_models(8, stage=1)
    pth = str(tmp_path / "STM_weights.pth")
    torch.save({f"module.{k}": v for k, v in stm.state_dict().items()}, pth)
    argv = ["--epochs", "2", "--data-root", data_root, "--input-size", "32", "--batch-size", "2",
            "--repeats", "2", "--workers", "2", "--max-iters", "1", "--init", pth]

    port = {"batches": [], "losses": [], "labels": []}
    record_steps(monkeypatch, cli_s1, "make_trimap_s1_train_step", port)
    record_ious(monkeypatch, cli_s1, port)
    res = run_port_cli(monkeypatch, str(tmp_path / "port"), cli_s1.main, argv)

    ref = {"batches": [], "losses": [], "labels": []}
    record_steps(monkeypatch, jtrainer, "make_trimap_s1_train_step", ref)
    record_ious(monkeypatch, jmetrics, ref)
    saved = run_jax_cli(monkeypatch, str(tmp_path / "jax"), "train_s1_trimap", argv)

    assert_same_training(port, ref, 2, LOSS_RTOL)
    assert res["losses"] == port["losses"] and res["state"].step == 2
    assert saved == [(os.path.join("weights", "s1_OTVM_trimap"), 1),
                     (os.path.join("weights", "s1_OTVM_trimap"), 2)]
    ckpt = torch.load(os.path.join(tmp_path, "port", "weights", "s1_OTVM_trimap"),
                      map_location="cpu", weights_only=True)
    assert ckpt["step"] == 2
    assert len(port["labels"]) == len(ref["labels"]) == 2
    for (pred, gt), (jpred, jgt) in zip(port["labels"], ref["labels"]):
        assert pred.shape == jpred.shape == (2, 2, 32, 32)
        np.testing.assert_array_equal(gt, jgt)
        assert (pred == jpred).mean() >= 0.99
