"""Shared helpers of the tests that hold the PyTorch port (otvm_tpu_torch)
against the JAX package: layout conversion and seeded JAX variables.

Variables come from numpy, not from flax's init: `jax.eval_shape` gives the
variable tree without compiling anything, and every leaf is drawn from a
numpy seed at a flax-like scale.  BN statistics, norm scales and biases are
perturbed away from their init values so that a swapped name mapping shows.
"""
from __future__ import annotations

import numpy as np
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
