"""The port's trimap-s1 training forward against the JAX package's, and
the control that a read without gradient fails the gradient check
(tests/test_torch_train_forward.py has the arguments and tolerances)."""
import pytest

pytest.importorskip("jax")

from tests.test_torch_train_forward import (  # noqa: E402,F401
    check_read_without_gradient_fails, check_trimap_forward, jax_runs)


def test_trimap_train_forward_matches_jax(jax_runs):
    check_trimap_forward(jax_runs("trimap"))


@pytest.mark.parametrize("case", ["trimap"])
def test_a_read_without_gradient_fails_the_check(jax_runs, monkeypatch, case):
    check_read_without_gradient_fails(jax_runs(case), monkeypatch, case)
