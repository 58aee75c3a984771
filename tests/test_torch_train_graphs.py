"""The device-step RAdam (otvm_tpu_torch/train/optim.py) and the train
steps' CUDA-graph options (train/graphs.py, trainer.make_train_step), on
the CPU:

  * RAdam with its count and scalars on the device equals the host-scalar
    RAdam it replaced (tests/host_radam.py) bit for bit over 12 steps:
    across the N_sma < 5 hold (steps 1-5, then 6) and a stair drop (step
    10 of 10), with and without weight decay, one parameter without a
    gradient.  It equals the JAX package's radam within
    tests/test_torch_optim.py's tolerances (that file, unchanged, runs
    the device-step RAdam);
  * the schedules take a device step and give their int step's value;
  * a state_dict of the host-scalar RAdam loads into the device-step one,
    into the moment and step tensors it already holds;
  * graphs=True refuses the CPU and a gloo process group; the CPU's
    default is the eager step;
  * under torch.use_deterministic_algorithms(True), the forms nn/ops.py
    takes (bilinear resize and adaptive pooling as matrix products, reflect
    padding as flipped slices) equal torch's ops, values and gradients, to
    fp32 rounding (the padding's values bit for bit), and so does the
    train step.
The graphed step itself runs on the card: tests/test_torch_train_graphs_cuda.py."""
import contextlib
import copy
import types

import numpy as np
import pytest
import torch

from otvm_tpu_torch import config
from otvm_tpu_torch.data.loader import encode_wire
from otvm_tpu_torch.nn import ops
from otvm_tpu_torch.parallel import dist as D
from otvm_tpu_torch.train import optim as topt
from otvm_tpu_torch.train import trainer as T
from otvm_tpu_torch.train.graphs import TrainStepGraphs
from tests import host_radam
from tests.torch_port import one_thread  # noqa: F401

SHAPES = {"w": (4, 5), "k": (3, 3, 2, 2), "b": (7,)}
STEPS, TOTAL = 12, 10            # the stair drops at step 10: (10 - 1) / 10 is not < 0.9


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.detach().contiguous().view(torch.int32)


def _pair(schedule, weight_decay, lr=1e-2, seed=0):
    """The same parameters under the host-scalar and the device-step RAdam."""
    rng = np.random.RandomState(seed)
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    made = []
    for mod in (host_radam, topt):
        params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
        opt = mod.RAdam(list(params.values()), lr=mod.SCHEDULES[schedule](lr, TOTAL),
                        weight_decay=weight_decay)
        made.append((params, opt))
    return made, rng


def _feed(params, grads, missing="b"):
    for k, p in params.items():
        p.grad = None if k == missing else torch.from_numpy(grads[k])


@pytest.mark.parametrize("schedule,weight_decay", [("stair", 0.0), ("stair", 1e-2),
                                                   ("poly", 1e-4), ("const", 1e-2)])
def test_device_step_radam_equals_the_host_scalar_one_bit_for_bit(schedule, weight_decay):
    ((hp, hopt), (dp, dopt)), rng = _pair(schedule, weight_decay)
    moved = {}
    for step in range(1, STEPS + 1):
        grads = {k: (0.3 * rng.randn(*s)).astype(np.float32) for k, s in SHAPES.items()}
        _feed(hp, grads)
        _feed(dp, grads)
        hup, dup = hopt.step(), dopt.step()
        for (k, h), d, hu, du in zip(hp.items(), dp.values(), hup, dup):
            assert torch.equal(_bits(h), _bits(d)), f"{k} step {step}"
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(_bits(hopt.state[h][key]), _bits(dopt.state[d][key])), \
                    f"{key} {k} step {step}"
            if step < 6:
                assert not du.any(), f"step {step} updated {k}"
            else:
                assert torch.equal(_bits(hu), _bits(du)), f"update {k} step {step}"
                moved[k] = bool(du.any())
        assert dopt.param_groups[0]["step"] == int(dopt.device_step) == step
    # every parameter moved, the one without a gradient by its weight decay
    assert moved == {"w": True, "k": True, "b": weight_decay > 0}


def test_schedules_take_a_device_step():
    for name in ("stair", "poly", "const"):
        fn = topt.SCHEDULES[name](1e-2, TOTAL)
        for step in (1, 9, 10, 11):
            got = fn(torch.tensor(step))
            assert got.dtype == torch.float32 and got.dim() == 0
            assert torch.equal(_bits(got), _bits(fn(step))), f"{name} step {step}"
    stair = topt.SCHEDULES["stair"](1e-2, TOTAL)
    assert float(stair(torch.tensor(9))) == np.float32(1e-2)
    assert float(stair(torch.tensor(10))) == np.float32(1e-3)


def test_a_host_scalar_state_dict_loads_into_the_tensors_held():
    """7 host-scalar steps saved; a device-step RAdam that has taken 2
    steps of its own loads them into its own moments and step tensor (a
    CUDA graph holds their addresses), and its next 5 steps equal the
    host-scalar run's bit for bit.  A state with no moments zeroes them."""
    ((hp, hopt), (dp, dopt)), rng = _pair("stair", 1e-2)
    grads = [{k: (0.3 * rng.randn(*s)).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    for g in grads[:7]:
        _feed(hp, g)
        hopt.step()
    for g in grads[:2]:
        _feed(dp, g)
        dopt.step()
    held = {id(x) for s in dopt.state.values() for x in s.values()}
    step_tensor = dopt.device_step
    for h, d in zip(hp.values(), dp.values()):
        d.data.copy_(h.data)
    dopt.load_state_dict(copy.deepcopy(hopt.state_dict()))     # as torch.save and load would
    assert {id(x) for s in dopt.state.values() for x in s.values()} == held
    assert dopt.device_step is step_tensor and dopt.param_groups[0]["step"] == 7
    for g in grads[7:]:
        _feed(hp, g)
        _feed(dp, g)
        hopt.step()
        dopt.step()
    assert int(dopt.device_step) == STEPS
    for h, d in zip(hp.values(), dp.values()):
        assert torch.equal(_bits(h), _bits(d))
        assert torch.equal(_bits(hopt.state[h]["exp_avg_sq"]), _bits(dopt.state[d]["exp_avg_sq"]))

    fresh = topt.RAdam(list(dp.values()), lr=1e-2)
    dopt.load_state_dict(fresh.state_dict())
    assert {id(x) for s in dopt.state.values() for x in s.values()} == held
    assert all(not x.any() for s in dopt.state.values() for x in s.values())
    assert dopt.param_groups[0]["step"] == 0


@pytest.fixture(scope="module")
def cpu_state():
    cfg = config.get_cfg_defaults()
    cfg.train.stage, cfg.model_scale = 4, 4
    rng = np.random.RandomState(0)
    b, s, hw = 1, 2, 64
    batch = encode_wire(dict(fg=rng.rand(b, s, hw, hw, 3), bg=rng.rand(b, s, hw, hw, 3),
                             alpha=rng.rand(b, s, hw, hw, 1),
                             tri=np.eye(3)[rng.randint(0, 3, (b, s, hw, hw))]))
    return cfg, T.init_train_state(cfg, seed=0, device="cpu"), batch


@pytest.mark.parametrize("factory", ["make_train_step", "make_trimap_s1_train_step"])
def test_graphs_true_refuses_the_cpu_and_a_process_group(cpu_state, factory, monkeypatch):
    """The CPU, and a gloo process group (an NCCL one takes the graphs:
    tests/test_torch_ddp_graphs.py)."""
    cfg, state, batch = cpu_state
    step = getattr(T, factory)(cfg, graphs=True)
    with pytest.raises(ValueError, match="CPU"):
        step(state, batch)
    assert state.step == 0 and state.optimizer.param_groups[0]["step"] == 0
    on_card = types.SimpleNamespace(device=torch.device("cuda"), group=object())
    monkeypatch.setattr(D, "group_backend", lambda group: "gloo")
    with pytest.raises(ValueError, match="process group is gloo"):
        step(on_card, batch)
    assert isinstance(step.graphs, TrainStepGraphs)
    assert getattr(T, factory)(cfg, graphs=False).graphs is None


def test_the_cpu_default_is_the_eager_step(cpu_state, one_thread):
    """make_train_step's default on a CPU state equals graphs=False bit for
    bit over 2 steps, and captures nothing."""
    cfg, state, batch = cpu_state
    start = {k: v.clone() for k, v in state.fba.state_dict().items()}
    runs = []
    for graphs in (None, False):
        state.fba.load_state_dict(start)
        run = T.TrainState(state.stm, state.fba,
                           T.make_optimizer(cfg, state.stm, state.fba, iters_per_epoch=1))
        step = T.make_train_step(cfg, graphs=graphs)
        losses = [step(run, batch)[1]["loss"].item() for _ in range(2)]
        runs.append((losses, [m.clone() for s in run.optimizer.state.values()
                              for m in s.values()]))
        if graphs is None:
            assert step.graphs.captures == 0 and not step.graphs._graphs
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


@contextlib.contextmanager
def _deterministic():
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("op,shape,arg", [
    ("resize", (2, 3, 10, 12), (20, 24)), ("resize", (2, 3, 20, 24), (10, 12)),
    ("resize", (1, 2, 7, 9), (32, 20)), ("pool", (2, 3, 7, 7), 6), ("pool", (1, 2, 10, 13), 3),
    ("pool", (1, 2, 9, 11), 1), ("pad", (2, 3, 9, 11), (2, 2, 2, 2)),
    ("pad", (2, 3, 9, 11), (0, 0, 2, 2)), ("pad", (1, 2, 6, 5), (1, 3, 2, 1))])
def test_deterministic_forms_equal_torchs_ops(op, shape, arg):
    call = {"resize": (ops.resize_bilinear, lambda x: torch.nn.functional.interpolate(
                x, size=arg, mode="bilinear", align_corners=False)),
            "pool": (lambda x, a: ops.AdaptiveAvgPool(a)(x),
                     lambda x: torch.nn.functional.adaptive_avg_pool2d(x, arg)),
            "pad": (ops.reflect_pad, lambda x: torch.nn.functional.pad(x, arg, mode="reflect"))}
    mine, theirs = call[op]
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).requires_grad_()
    want = theirs(x)
    g = torch.from_numpy(rng.randn(*want.shape).astype(np.float32))
    want_grad, = torch.autograd.grad(want, x, g)
    with _deterministic():
        got = mine(x, arg)
        got_grad, = torch.autograd.grad(got, x, g)
    if op == "pad":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(got_grad, want_grad, rtol=0, atol=1e-5)


def test_the_deterministic_step_equals_the_default_to_rounding(cpu_state, one_thread):
    """One eager stage-4 step in each mode: the losses agree to fp32
    rounding.  (Its gradients part by more: at scale 4 the FBA's 1x1
    pooling branch group-normalizes 2 values a group, which amplifies the
    pooling's rounding; each form's gradient is held above.)"""
    cfg, state, batch = cpu_state
    start = {k: v.clone() for k, v in state.fba.state_dict().items()}
    runs = []
    for mode in (contextlib.nullcontext, _deterministic):
        state.fba.load_state_dict(start)
        run = T.TrainState(state.stm, state.fba,
                           T.make_optimizer(cfg, state.stm, state.fba, iters_per_epoch=1))
        with mode():
            runs.append(T.make_train_step(cfg)(run, batch)[1])
    for k in runs[0]:
        torch.testing.assert_close(runs[1][k], runs[0][k], rtol=1e-6, atol=1e-7)
