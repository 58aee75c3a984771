"""The port's joint training forward at stage 4 against the JAX package's,
and the control that a read without gradient fails the gradient check
(tests/test_torch_train_forward.py has the arguments and tolerances)."""
import pytest

pytest.importorskip("jax")

from tests.test_torch_train_forward import (  # noqa: E402,F401
    check_joint_forward, check_joint_gradients, check_read_without_gradient_fails,
    jax_runs)


@pytest.mark.parametrize("stage", [4])
def test_joint_train_forward_matches_jax(jax_runs, stage):
    check_joint_forward(jax_runs(stage), stage)


@pytest.mark.parametrize("stage", [4])
def test_joint_gradients_match_jax(jax_runs, stage):
    check_joint_gradients(jax_runs(stage), stage)


@pytest.mark.parametrize("case", [4])
def test_a_read_without_gradient_fails_the_check(jax_runs, monkeypatch, case):
    check_read_without_gradient_fails(jax_runs(case), monkeypatch, case)
