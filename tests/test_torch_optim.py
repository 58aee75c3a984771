"""The port's RAdam and schedules (otvm_tpu_torch.train.optim) against the
JAX package's (otvm_tpu.train.optim), on the same numpy parameters and
gradients, fp32 on the CPU.

RAdam applies nothing on steps 1-5 (N_sma < 5 with beta2 0.999) and updates
from step 6 on; 10 steps cross that line.  The updates are compared as well
as the parameters: at a learning rate of 1e-5 a parameter near 1 hides an
update's error below its own rounding.  Tolerances, of each tensor's
largest magnitude: 1e-6 on moments and parameters (the same fp32
arithmetic in the same order; XLA may fuse a multiply-add); 2e-4 on
updates: XLA's and torch's fp32 expm1 differ in the last bit or two, and
N_sma = 1999 - 2t b2^t / (1 - b2^t) cancels ~1994 of 1999 at step 6, so
the rectification scale there differs by ~1e-4 (less later).  Weight decay
1e-2 moves an update by 1%, so the check sees it; 1e-4 is the trainer's.
Steps that do not update give exact zeros."""
import copy

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from otvm_tpu.train import optim as jopt
from otvm_tpu_torch.train import optim as topt

SHAPES = {"w": (4, 5), "k": (3, 3, 2, 2), "b": (7,)}
STEPS = 10


def _run(weight_decay, lr, schedule=None, seed=0, missing=()):
    """Both optimizers on the same gradients; the keys in `missing` get no
    gradient in the port (grad None) and zeros in JAX, as jax.grad gives a
    leaf that the loss does not reach."""
    rng = np.random.RandomState(seed)
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (0.3 * rng.randn(*s) * (k not in missing)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    jlr = lr if schedule is None else jopt.SCHEDULES[schedule](lr, STEPS)
    tlr = lr if schedule is None else topt.SCHEDULES[schedule](lr, STEPS)

    tx = jopt.radam(jlr, weight_decay=weight_decay)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(params)
    step = jax.jit(lambda p, s, g: tx.update(g, s, p))

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = topt.RAdam(list(tparams.values()), lr=tlr, weight_decay=weight_decay)
    for i, g in enumerate(grads):
        updates, state = step(params, state, {k: jnp.asarray(v) for k, v in g.items()})
        params = jax.tree_util.tree_map(lambda a, u: a + u, params, updates)
        for k, p in tparams.items():
            p.grad = None if k in missing else torch.from_numpy(g[k])
        tupdates = dict(zip(tparams, opt.step()))
        yield i + 1, updates, tupdates, params, tparams, state, opt


def _close(got, want, what, tol=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4, 1e-2])
@pytest.mark.parametrize("lr,schedule", [(1e-5, None), (1e-2, None), (1e-5, "stair"),
                                         (1e-3, "poly")])
def test_radam_matches_jax_step_for_step(weight_decay, lr, schedule):
    for step, updates, tupdates, params, tparams, state, opt in _run(weight_decay, lr, schedule):
        for k in SHAPES:
            u, tu = np.asarray(updates[k]), tupdates[k].numpy()
            if step < 6:
                assert not tu.any() and not u.any(), f"step {step} updated {k}"
            else:
                assert np.abs(tu).max() > 0
                _close(tu, u, f"update {k} step {step}", tol=2e-4)
            st = opt.state[tparams[k]]
            _close(tparams[k].detach().numpy(), params[k], f"{k} step {step}")
            _close(st["exp_avg"].numpy(), state.exp_avg[k], f"exp_avg {k} step {step}")
            _close(st["exp_avg_sq"].numpy(), state.exp_avg_sq[k], f"exp_avg_sq {k} step {step}")
        assert opt.param_groups[0]["step"] == int(state.step) == step


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_radam_takes_a_missing_gradient_as_zero(weight_decay):
    """A parameter without a gradient keeps moments that decay (zero here)
    and, from step 6, takes the weight decay: the JAX package's update for
    a zero gradient."""
    for step, updates, tupdates, params, tparams, state, opt in _run(
            weight_decay, 1e-2, missing=("b",)):
        u, tu = np.asarray(updates["b"]), tupdates["b"].numpy()
        assert tu.any() == u.any() == (step >= 6 and weight_decay > 0), f"step {step}"
        if u.any():
            _close(tu, u, f"update b step {step}", tol=2e-4)
        for k in SHAPES:
            _close(tparams[k].detach().numpy(), params[k], f"{k} step {step}")
            _close(opt.state[tparams[k]]["exp_avg"].numpy(), state.exp_avg[k], f"exp_avg {k}")
        assert tparams["b"].grad is None


@pytest.mark.parametrize("name", ["stair", "poly", "const"])
def test_schedules_match_jax(name):
    jfn, tfn = jopt.SCHEDULES[name](1e-5, 1000), topt.SCHEDULES[name](1e-5, 1000)
    for step in (1, 2, 500, 900, 901, 999, 1000):
        want = np.float32(jfn(jnp.asarray(step, jnp.int32)))
        got = tfn(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), want, rtol=1e-6, err_msg=f"step {step}")


def test_radam_state_dict_round_trip_keeps_the_step_and_not_the_schedule():
    p = torch.nn.Parameter(torch.ones(3))
    opt = topt.RAdam([p], lr=topt.stair_schedule(1e-2, 10), weight_decay=1e-4)
    for _ in range(7):
        p.grad = torch.full((3,), 0.5)
        opt.step()
    sd = opt.state_dict()
    assert all(not callable(v) for group in sd["param_groups"] for v in group.values())
    q = torch.nn.Parameter(p.detach().clone())
    fresh = topt.RAdam([q], lr=topt.stair_schedule(1e-2, 10), weight_decay=1e-4)
    fresh.load_state_dict(copy.deepcopy(sd))     # as torch.save and torch.load would
    assert fresh.param_groups[0]["step"] == 7
    p.grad, q.grad = torch.full((3,), 0.5), torch.full((3,), 0.5)
    assert torch.equal(opt.step()[0], fresh.step()[0])
    assert torch.equal(p, q)
