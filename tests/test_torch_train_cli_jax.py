"""The port's train CLI (otvm_tpu_torch/cli/train.py) held against the JAX
package's train.py, each run in this process through its main() with the
same argv on the same data tree and the same `--init` weights, fp32 on the
CPU.

What the CLI wires together is compared, not the parts (their own tests
hold those): each batch as the step receives it (epoch_indices, the
Loader's seed per epoch, the curriculum's max_skip per epoch, encode_wire's
keys and bytes) must be equal, and so must the losses, the logged loss,
the steps taken, the checkpoints saved (path and step) and the config
snapshot.

Stage 4 on VideoMatting108 at model scale 4, 64x64 crops, B 2, two epochs
of one step each, `--init` from one joint .pth.  The JAX package's .pth
importer knows only the full-depth trunks, so its run reads the file
through the port's load_pth and convert.to_jax at scale 4; the rest of its
`--init` path runs as it is.  The losses: rtol 1e-5,
tests/test_torch_train_forward.py's bound for the same forward (fp32
summation order); the second comes after one RAdam step at lr 1e-5 whose
gradients differ by at most that file's GRAD_TOL (1e-2, relative), which
moves the loss far less.
"""
import os

import numpy as np
import pytest
import torch
import yaml

jax = pytest.importorskip("jax")
pytest.importorskip("cv2")

import otvm_tpu.train.trainer as jtrainer
import otvm_tpu.utils.checkpoint as jckpt
from otvm_tpu_torch.cli import train as cli_train
from otvm_tpu_torch.config import get_cfg_defaults
from otvm_tpu_torch.convert import load_pth, to_jax
from otvm_tpu_torch.models.otvm import init_models

from tests.torch_port import (assert_same_training, one_thread,  # noqa: F401
                              record_steps, run_jax_cli, run_port_cli, write_train_tree)

SCALE = 4
LOSS_RTOL = 1e-5


def test_train_cli_matches_jax_train_py(tmp_path, monkeypatch):
    data_root = write_train_tree(tmp_path / "data", 96, 128)
    stm, fba = init_models(7, stage=4, scale=SCALE)
    sd = {f"trimap.model.{k}": v for k, v in stm.state_dict().items()}
    sd.update({f"NET.{k}": v for k, v in fba.state_dict().items()})
    pth = str(tmp_path / "joint.pth")
    torch.save({"state_dict": sd}, pth)
    argv = ["--stage", "4", "--epochs", "2", "--data-root", data_root, "--input-size", "64",
            "--batch-size", "2", "--repeats", "1", "--workers", "2", "--init", pth]

    port = {"batches": [], "losses": []}
    record_steps(monkeypatch, cli_train, "make_train_step", port)
    scaled = get_cfg_defaults()
    scaled.model_scale = SCALE
    monkeypatch.setattr(cli_train, "get_cfg_defaults", lambda: scaled)
    res = run_port_cli(monkeypatch, str(tmp_path / "port"), cli_train.main, argv)

    ref = {"batches": [], "losses": []}
    record_steps(monkeypatch, jtrainer, "make_train_step", ref)
    monkeypatch.setattr(jckpt, "import_torch_checkpoint", lambda path, stage: dict(
        zip(("trimap", "alpha"), to_jax(*load_pth(path), stage, SCALE))))
    saved = run_jax_cli(monkeypatch, str(tmp_path / "jax"), "train", argv, scale=SCALE)

    assert_same_training(port, ref, 2, LOSS_RTOL)
    assert res["losses"] == port["losses"] and res["state"].step == 2
    assert saved == [(os.path.join("train_log", "s4_OTVM", "ckpt_e2"), 2),
                     (os.path.join("weights", "s4_OTVM"), 2)]
    for path, step in saved:
        ckpt = torch.load(os.path.join(tmp_path, "port", path), map_location="cpu",
                          weights_only=True)
        assert ckpt["step"] == step, path
    snapshot = os.path.join("train_log", "s4_OTVM", "config.yaml")
    port_cfg, jax_cfg = (yaml.safe_load(open(os.path.join(tmp_path, side, snapshot)))
                         for side in ("port", "jax"))
    assert port_cfg == jax_cfg
    assert np.isfinite(port["losses"]).all()
