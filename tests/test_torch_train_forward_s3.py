"""The port's joint training forward at stage 3 against the JAX package's,
and stage 4's with the exact EDT's clicks (tests/test_torch_train_forward.py
has the arguments and tolerances; each file of the split runs its own
JAX compiles)."""
import pytest

pytest.importorskip("jax")

from tests.test_torch_train_forward import (  # noqa: E402,F401
    check_exact_edt_forward, check_joint_forward, check_joint_gradients, jax_runs)


@pytest.mark.parametrize("stage", [3])
def test_joint_train_forward_matches_jax(jax_runs, stage):
    check_joint_forward(jax_runs(stage), stage)


@pytest.mark.parametrize("stage", [3])
def test_joint_gradients_match_jax(jax_runs, stage):
    check_joint_gradients(jax_runs(stage), stage)


def test_joint_train_forward_exact_edt_matches_jax():
    check_exact_edt_forward()
