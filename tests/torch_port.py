"""Shared helpers of the tests that hold the PyTorch port (otvm_tpu_torch)
against the JAX package: layout conversion, seeded JAX variables, a small
training-data tree, and the means to run a training CLI of each package
in one process and record what it did.

Variables come from numpy, not from flax's init: `jax.eval_shape` gives the
variable tree without compiling anything, and every leaf is drawn from a
numpy seed at a flax-like scale.  BN statistics, norm scales and biases are
perturbed away from their init values so that a swapped name mapping shows.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def random_variables(tree, rng: np.random.RandomState):
    """Same structure as `tree` (leaves with .shape), numpy leaves."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "shape"):
            shape = tuple(v.shape)
            if k == "kernel":      # HWIO: lecun-normal scale
                a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
            elif k in ("scale", "var"):
                a = 1.0 + 0.2 * rng.rand(*shape)
            else:                  # bias, mean
                a = 0.1 * rng.randn(*shape)
            out[k] = a.astype(np.float32)
        else:
            out[k] = random_variables(v, rng)
    return out


def jax_joint_variables(stage: int, scale: int, height: int, width: int, seed: int = 0,
                        stm_norm: str = "frozen_bn"):
    """(stm_vars, fba_vars) of the JAX package's models for `stage`, numpy."""
    import jax

    from otvm_tpu.config import get_cfg_defaults
    from otvm_tpu.train.trainer import init_train_state

    cfg = get_cfg_defaults()
    cfg.train.stage = stage
    cfg.model_scale = scale
    cfg.stm_norm = stm_norm
    shapes = jax.eval_shape(
        lambda: init_train_state(cfg, jax.random.PRNGKey(0), None, height, width))
    rng = np.random.RandomState(seed)
    stm_vars = {"params": random_variables(shapes.params["stm"], rng)}
    if shapes.batch_stats:
        stm_vars["batch_stats"] = random_variables(shapes.batch_stats, rng)
    fba_vars = {"params": random_variables(shapes.params["fba"], rng)}
    return stm_vars, fba_vars


def write_train_tree(root, h: int, w: int) -> str:
    """Combined_Dataset/ (2 foregrounds, 2 backgrounds) and
    VideoMatting108/ (2 training clips of 8 frames) at h x w under the
    pathlib.Path `root`, seeded; returns str(root)."""
    import cv2

    def circle(r, shift=0):
        yy, xx = np.mgrid[:h, :w]
        return np.clip((r * h - np.hypot(yy - h / 2, xx - w / 2 - shift)) / 4 + 0.5, 0, 1)

    rng = np.random.RandomState(0)
    base = root / "Combined_Dataset" / "Training_set"
    fgd, ald = base / "Adobe-licensed images" / "fg", base / "Adobe-licensed images" / "alpha"
    for d in (fgd, ald, base / "train2014"):
        d.mkdir(parents=True)
    for i in range(2):
        cv2.imwrite(str(fgd / f"fg{i}.png"), rng.randint(0, 255, (h, w, 3), np.uint8))
        cv2.imwrite(str(ald / f"fg{i}.png"), (circle(0.3) * 255).astype(np.uint8))
        cv2.imwrite(str(base / "train2014" / f"bg{i}.jpg"), rng.randint(0, 255, (h, w, 3), np.uint8))
    (base / "training_fg_names.txt").write_text("fg0.png\nfg1.png")
    vm = root / "VideoMatting108"
    corr = {}
    for seq in ("vidA", "vidB"):
        (vm / "FG_done" / seq).mkdir(parents=True)
        (vm / "BG_done2" / seq).mkdir(parents=True)
        for i in range(8):
            fn = f"{seq}/{i:05d}.png"
            rgba = np.dstack([rng.randint(0, 255, (h, w, 3), np.uint8),
                              (circle(0.25, 2 * i) * 255).astype(np.uint8)])
            cv2.imwrite(str(vm / "FG_done" / fn), rgba)
            cv2.imwrite(str(vm / "BG_done2" / fn), rng.randint(0, 255, (h, w, 3), np.uint8))
            corr[fn] = fn
    (vm / "frame_corr.json").write_text(json.dumps(corr))
    (vm / "train_videos.txt").write_text("vidA\nvidB")
    return str(root)


# ---------------------------------------------------------------------------
# the port's training CLIs against the JAX package's, in one process
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True)
def one_thread():
    """One torch and one cv2 thread a test: the suite runs several test
    processes at once, and each library's pool over every core would
    oversubscribe the host (every parallel region of the small models'
    many small ops then waits for descheduled threads)."""
    import cv2

    threads, cv_threads = torch.get_num_threads(), cv2.getNumThreads()
    torch.set_num_threads(1)
    cv2.setNumThreads(1)
    yield
    torch.set_num_threads(threads)
    cv2.setNumThreads(cv_threads)


def record_steps(monkeypatch, module, name: str, log: dict) -> None:
    """Wraps module.<name>, a train-step factory, so that each step's batch
    (as numpy, as the step receives it) and loss land in log['batches'] and
    log['losses']."""
    make = getattr(module, name)

    def wrapped(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(state, batch):
            log["batches"].append({k: np.array(v) for k, v in batch.items()})
            state, metrics = step(state, batch)
            log["losses"].append(float(metrics["loss"]))
            return state, metrics

        return run

    monkeypatch.setattr(module, name, wrapped)


def record_ious(monkeypatch, module, log: dict) -> None:
    """Wraps module.reference_iou so that its (pred, gt) labels land in
    log['labels']."""
    iou = module.reference_iou

    def wrapped(pred, gt):
        log["labels"].append((np.array(pred), np.array(gt)))
        return iou(pred, gt)

    monkeypatch.setattr(module, "reference_iou", wrapped)


def run_jax_cli(monkeypatch, cwd: str, name: str, argv, scale: int = 1):
    """The JAX package's <name>.py main() with `argv`, working directory
    `cwd`, at `scale`, on one device: each batch goes to the step as the
    host's arrays, not sharded over the suite's 8 virtual CPU devices
    (which would split a batch of 2; a batch placed on a one-device mesh
    makes the step's outputs carry the mesh, and the second step would
    compile the step again, ~50 s here).  Its random init is built from
    its shapes alone, as zeros: `--init` overwrites every value of it
    (params and BN statistics), and compiling the init of both full-width
    networks would double a test's time.  Its checkpoints (orbax, the JAX
    package's format) are recorded, not written: returns [(path, step)]."""
    import importlib.util
    import os
    import sys

    import jax
    import jax.numpy as jnp

    import otvm_tpu.config as jconfig
    import otvm_tpu.parallel.mesh as jmesh
    import otvm_tpu.train.trainer as jtrainer
    import otvm_tpu.utils.checkpoint as jckpt

    init = jtrainer.init_train_state

    def shaped(*args, **kwargs):
        shapes = jax.eval_shape(lambda: init(*args, **kwargs))
        return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    defaults = jconfig.get_cfg_defaults

    def scaled():
        cfg = defaults()
        cfg.model_scale = scale
        return cfg

    saved = []
    monkeypatch.setattr(jtrainer, "init_train_state", shaped)
    monkeypatch.setattr(jmesh, "shard_batch", lambda mesh, batch: batch)
    monkeypatch.setattr(jconfig, "get_cfg_defaults", scaled)
    monkeypatch.setattr(jckpt, "save_train_state", lambda path, state: saved.append(
        (os.path.normpath(path), int(state.step))))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(f"_jax_cli_{name}",
                                                  os.path.join(repo, f"{name}.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    os.makedirs(cwd)
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + list(argv))
    cli.main()
    return saved


def run_port_cli(monkeypatch, cwd: str, main, argv):
    """The port's CLI main(argv) on the CPU, working directory `cwd`."""
    import os

    os.makedirs(cwd)
    monkeypatch.chdir(cwd)
    return main(["--device", "cpu"] + list(argv))


def assert_same_training(port: dict, ref: dict, n_steps: int, loss_rtol: float) -> None:
    """Both CLIs stepped n_steps times on equal batches (keys, dtypes,
    bytes) to losses within loss_rtol."""
    assert len(port["batches"]) == len(ref["batches"]) == n_steps
    for got, want in zip(port["batches"], ref["batches"]):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=loss_rtol)
