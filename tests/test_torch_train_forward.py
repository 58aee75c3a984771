"""The port's training forwards (otvm_tpu_torch.models.otvm.
joint_train_forward at stages 1-4, trimap_train_forward) against the JAX
package's, with the same weights (the port's flax-style random init, carried
to JAX by convert.to_jax) and the same numpy batch, fp32 on the CPU: the
losses, the network outputs, and the gradients of every parameter against
jax.grad's.

  * joint: scale=4 models, 64x64, B=1, S=3; trimap: the full-width STM
    (the JAX package's trimap forward builds only that one), 32x32.
  * One JAX value_and_grad compile a case, so the cases are spread over
    files that the suite's workers take in parallel: stages 1-2 and the
    torch-only remat and bf16 checks here, stage 3 and the exact EDT in
    test_torch_train_forward_s3.py, stage 4 in ..._s4.py, the trimap
    forward in ..._trimap.py (each with its read-without-gradient control
    where it has a read).
  * Losses: rtol 1e-5 (fp32 summation order; measured <= 1e-6).
  * Outputs: frame 0 reads the GT trimap: every value within 1e-3 (fp32
    summation order, amplified where fba_fusion divides by
    sum((F-B)^2) + 0.1).  At stage >= 2 later frames read a propagated
    trimap through an argmax, and random weights leave pixels
    where two classes tie within fp32 noise.  As in test_torch_stream.py,
    at most 1% of values may differ by more than 1e-3, and at least 99% of
    trimap labels agree.  The distance features come from the port's own
    JFA, bit-exact with JAX's on such maps (tests/test_torch_edt.py).
  * Gradients, norm-relative per top-level module (the JAX params tree's
    first level): GRAD_TOL, at one torch thread (the module's pin) and at
    8.  Both frameworks' fp32 gradients lie 2e-4..3e-3 from the port's
    own fp64 gradient at stage 4 (the GroupNorms of the
    scale-4 model's pyramid pooling see two channels at one pixel and are
    ill-conditioned), so they differ by that much from each other.  A read
    whose backward returns zero (the CUDA read's fault before it had an
    autograd Function) moves whole modules by 0.04..1.0 and must fail.
  * Clamps are ties: where fba_fusion's alpha, F or B (or the head's
    alpha) lies within fp32 rounding of 0 or 1, the clamp passes that
    pixel's whole gradient or none, by rounding.  Stage 2's first batch
    (seed 12) had one such pixel, its fused alpha 2.0e-5 above 0 in fp64:
    one torch thread clamped it and 8 did not, and that one pixel moved
    fba/encoder's gradient by 4.8% against JAX's.  Stages 1 and 2's
    batches (BATCH_SEEDS) leave every clamp and trimap label of the fp32
    run on the side the fp64 run takes, at 1 and 8 threads (check_no_ties,
    asserted before their gradient checks).
"""
import copy

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from otvm_tpu.models.otvm import joint_train_forward as jax_joint_train_forward
from otvm_tpu.models.otvm import trimap_train_forward as jax_trimap_train_forward
from otvm_tpu_torch.convert import params_to_jax, to_jax
from otvm_tpu_torch.kernels import memory_attn as ma
from otvm_tpu_torch.models import fba as fba_module
from otvm_tpu_torch.models import otvm as otvm_module
from otvm_tpu_torch.models.otvm import (init_models, joint_train_forward, make_models,
                                        trimap_train_forward)
from otvm_tpu_torch.models.stm import STM
from otvm_tpu_torch.nn.layers import init_flax_style
from tests.torch_port import one_thread  # noqa: F401

B, S, H, W, SCALE = 1, 3, 64, 64, 4
TRI_HW = 32
GRAD_TOL = 1e-2
LOSSES = ("L_alpha_comp", "L_lap", "L_grad", "L_tri")
BATCH_SEEDS = {1: 11, 2: 68, 3: 13, 4: 14}


def _batch(seed, h, w):
    rng = np.random.RandomState(seed)
    fg, bg = rng.rand(B, S, h, w, 3).astype(np.float32), rng.rand(B, S, h, w, 3).astype(np.float32)
    alpha = rng.rand(B, S, h, w, 1).astype(np.float32)
    tri = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (B, S, h, w))]
    return dict(fg=fg, bg=bg, alpha=alpha, tri=tri)


def _joint_jax(stage):
    stm, fba = init_models(seed=stage, stage=stage, scale=SCALE)
    stm_vars, fba_vars = to_jax(stm.state_dict(), fba.state_dict(), stage, SCALE)
    batch = _batch(BATCH_SEEDS[stage], H, W)

    def loss_fn(params, batch_stats, batch):
        total, aux = jax_joint_train_forward(
            {"params": params["stm"], "batch_stats": batch_stats}, {"params": params["fba"]},
            batch, stage, scale=SCALE)
        return total, aux

    (total, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        {"stm": stm_vars["params"], "fba": fba_vars["params"]}, stm_vars["batch_stats"],
        {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(stm=stm, fba=fba, batch=batch, total=float(total),
                aux={k: np.asarray(v) for k, v in aux.items()},
                grads=jax.tree_util.tree_map(np.asarray, grads))


def _trimap_jax():
    stm = STM(hdim=-1)
    init_flax_style(stm, torch.Generator().manual_seed(5))
    stm_vars = to_jax(stm.state_dict(), make_models(1)[1].state_dict(), stage=1)[0]
    b = _batch(20, TRI_HW, TRI_HW)
    batch = dict(img=b["fg"] * b["alpha"] + b["bg"] * (1 - b["alpha"]), tri=b["tri"])

    def loss_fn(params, batch_stats, batch):
        return jax_trimap_train_forward({"params": params, "batch_stats": batch_stats}, batch)

    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        stm_vars["params"], stm_vars["batch_stats"], {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(stm=stm, batch=batch, total=float(loss), pred=np.asarray(aux["pred"]),
                grads={"stm": jax.tree_util.tree_map(np.asarray, grads)})


@pytest.fixture(scope="module")
def jax_runs():
    """One JAX value_and_grad compile per case, shared by the tests."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _trimap_jax() if case == "trimap" else _joint_jax(case)
        return cache[case]

    return get


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_grads(run, stage, **kwargs):
    """The port's loss, aux and gradients as the JAX params tree (a
    parameter that the loss does not reach: zero, as jax.grad gives)."""
    for p in run["stm"].parameters():
        p.grad = None
    if "fba" in run:
        for p in run["fba"].parameters():
            p.grad = None
        total, aux = joint_train_forward(run["stm"], run["fba"], _torch_batch(run["batch"]),
                                         stage, **kwargs)
        fba = run["fba"]
    else:
        total, aux = trimap_train_forward(run["stm"], _torch_batch(run["batch"]), **kwargs)
        fba = make_models(1)[1]
    total.backward()
    named = lambda m: {n: p.grad if p.grad is not None else torch.zeros_like(p)
                       for n, p in m.named_parameters()}
    grads = params_to_jax(named(run["stm"]), named(fba), stage, SCALE if "fba" in run else 1)
    return total, aux, grads if "fba" in run else {"stm": grads["stm"]}


def _grad_errors(got, want):
    """{net/top-level module: ||got - want|| / ||want||} (0 where both are 0)."""
    errs = {}
    for net in want:
        for top in want[net]:
            a = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(want[net][top])])
            b = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(got[net][top])])
            norm = np.linalg.norm(a)
            errs[f"{net}/{top}"] = (np.linalg.norm(a - b) / norm if norm
                                    else float(np.linalg.norm(b) > 0))
    return errs


def _mostly_close(got, want, what):
    bad = np.abs(got - want) > 1e-3
    assert bad.mean() <= 0.01, f"{what}: {bad.mean():.3%} of values off by more than 1e-3"


def check_joint_forward(run, stage):
    total, aux, _ = _port_grads(run, stage)
    np.testing.assert_allclose(total.item(), run["total"], rtol=1e-5)
    for k in LOSSES:
        np.testing.assert_allclose(aux[k].item(), float(run["aux"][k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for k in ("alphas", "comps"):
        assert aux[k].shape == (B, S, H, W, 1 if k == "alphas" else 3)
        np.testing.assert_allclose(aux[k][:, 0].detach().numpy(), run["aux"][k][:, 0], atol=1e-3)
        _mostly_close(aux[k].detach().numpy(), run["aux"][k], k)
    keys = {"logit_trimap"} if stage == 2 else {"logit_trimap", "logit_trimap_refine"}
    assert set(aux) - {"alphas", "comps", *LOSSES} == (keys if stage > 1 else set())
    for k in keys if stage > 1 else ():
        got, want = aux[k].detach().numpy(), run["aux"][k]
        _mostly_close(got, want, k)
        assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99, f"{k}: labels disagree"


def _at_threads(n, fn, *args):
    threads = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        return fn(*args)
    finally:
        torch.set_num_threads(threads)


def check_joint_gradients(run, stage):
    for threads in (1, 8):
        errs = _grad_errors(_at_threads(threads, _port_grads, run, stage)[2], run["grads"])
        assert max(errs.values()) <= GRAD_TOL, (threads, errs)
    if stage == 1:   # the trimap net takes no part at stage 1
        assert all(not np.any(x) for x in jax.tree_util.tree_leaves(run["grads"]["stm"]))


class _ClampSides:
    """models/fba.py's `torch` where each clamp also records which side of
    0 and of 1 its input takes (in the FBA head: alpha, then fba_fusion's
    F, B and fused alpha)."""

    def __init__(self, seen):
        self.seen = seen

    def __getattr__(self, name):
        return getattr(torch, name)

    def clamp(self, x, lo, hi):
        v = x.detach()
        self.seen.append(torch.cat([torch.sign(v - lo), torch.sign(v - hi)], dim=1)
                         .to(torch.int8))
        return torch.clamp(x, lo, hi)


def _branches(run, stage, dtype):
    """The clamp sides of every head call and the labels of every trimap
    that makes trimap features, in a forward of `run` in `dtype`."""
    seen = []
    head, features = fba_module._head, otvm_module.make_trimap_features

    def spy_head(x7, img):
        with pytest.MonkeyPatch.context() as clamps:
            clamps.setattr(fba_module, "torch", _ClampSides(seen))
            return head(x7, img)

    def spy_features(trimap, exact_edt=False):
        seen.append(trimap.detach().argmax(-1).to(torch.int8))
        return features(trimap, exact_edt)

    stm, fba = (copy.deepcopy(run[k]).to(dtype) for k in ("stm", "fba"))
    batch = {k: torch.from_numpy(v).to(dtype) for k, v in run["batch"].items()}
    with pytest.MonkeyPatch.context() as mp:    # with autograd, as the gradient runs
        mp.setattr(fba_module, "_head", spy_head)
        mp.setattr(otvm_module, "make_trimap_features", spy_features)
        joint_train_forward(stm, fba, batch, stage)
    return seen


def check_no_ties(run, stage):
    """The batch is away from every clamp's and argmax's tie: the fp32
    forward at 1 and at 8 threads takes the fp64 forward's side of each."""
    want = _branches(run, stage, torch.float64)
    for threads in (1, 8):
        got = _at_threads(threads, _branches, run, stage, torch.float32)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g, w), (threads, i, int((g != w).sum()))


def check_trimap_forward(run):
    total, aux, grads = _port_grads(run, 1)
    np.testing.assert_allclose(total.item(), run["total"], rtol=1e-5)
    pred = aux["pred"].detach().numpy()
    assert pred.shape == (B, S, TRI_HW, TRI_HW, 3)
    np.testing.assert_array_equal(pred[:, 0], run["pred"][:, 0])
    _mostly_close(pred, run["pred"], "pred")
    assert (pred.argmax(-1) == run["pred"].argmax(-1)).mean() >= 0.99
    errs = _grad_errors(grads, run["grads"])
    assert max(errs.values()) <= GRAD_TOL, errs


def check_read_without_gradient_fails(run, monkeypatch, case):
    """The control: the read's backward replaced by zeros."""
    monkeypatch.setattr(ma, "memory_read_vjp_plain", lambda q, k, v, m, g: (
        torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)))
    errs = _grad_errors(_port_grads(run, 4 if case == 4 else 1)[2], run["grads"])
    assert max(errs.values()) > GRAD_TOL, errs


@pytest.mark.parametrize("stage", [1, 2])
def test_joint_train_forward_matches_jax(jax_runs, stage):
    check_joint_forward(jax_runs(stage), stage)


@pytest.mark.parametrize("stage", [1, 2])
def test_joint_gradients_match_jax(jax_runs, stage):
    check_no_ties(jax_runs(stage), stage)
    check_joint_gradients(jax_runs(stage), stage)


def test_remat_recomputes_the_same_loss_and_gradients():
    """Bit for bit, on one CPU thread: with several, the CPU backward's
    reductions (conv weight gradients) split work by thread and are not
    reproducible from run to run, remat or not."""
    stm, fba = init_models(seed=6, stage=4, scale=SCALE)
    batch = _torch_batch(_batch(30, H, W))
    grads = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for remat in (False, True):
            stm.zero_grad(set_to_none=True)
            fba.zero_grad(set_to_none=True)
            total, _ = joint_train_forward(stm, fba, batch, 4, remat=remat)
            total.backward()
            grads.append((total.item(), [p.grad.clone() for p in (*stm.parameters(),
                                                                   *fba.parameters())]))
    finally:
        torch.set_num_threads(threads)
    assert grads[0][0] == grads[1][0]
    for a, b in zip(grads[0][1], grads[1][1]):
        assert torch.equal(a, b)


def test_bf16_compute_reaches_fp32_masters():
    """compute_dtype=bf16: the networks run in bf16 (the read too), the
    gradients land on the fp32 parameters, and the loss stays fp32, finite,
    and within 10% of the fp32 loss on the same weights and batch (random
    weights: bf16 rounding through ~60 layers, not a broken path)."""
    stm, fba = init_models(seed=7, stage=4, scale=SCALE)
    batch = _torch_batch(_batch(31, H, W))
    reads = []
    monkeypatch_read = ma.memory_read_plain

    def spy(q, *args):
        reads.append(q.dtype)
        return monkeypatch_read(q, *args)

    ma.memory_read_plain = spy
    try:
        total, _ = joint_train_forward(stm, fba, batch, 4, compute_dtype=torch.bfloat16)
    finally:
        ma.memory_read_plain = monkeypatch_read
    total.backward()
    assert total.dtype == torch.float32 and torch.isfinite(total)
    assert reads == [torch.bfloat16] * (S - 1)
    for net in (stm, fba):
        params = list(net.parameters())
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in params)
        assert all(torch.isfinite(p.grad).all() for p in params)
        assert sum(p.grad.abs().sum().item() for p in params) > 0
    with torch.no_grad():
        fp32, _ = joint_train_forward(stm, fba, batch, 4)
    assert abs(total.item() - fp32.item()) <= 0.1 * fp32.item()


def check_exact_edt_forward():
    """Stage 4 with the clicks from the exact EDT (exact_edt=True, bit-exact
    with JAX's: tests/test_torch_edt.py): the losses against JAX's forward
    on the same weights and batch, rtol 1e-5."""
    stm, fba = init_models(seed=4, stage=4, scale=SCALE)
    stm_vars, fba_vars = to_jax(stm.state_dict(), fba.state_dict(), 4, SCALE)
    batch = _batch(14, H, W)
    total, aux = jax.jit(lambda s, f, b: jax_joint_train_forward(
        s, f, b, 4, exact_edt=True, scale=SCALE))(
        stm_vars, fba_vars, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got, got_aux = joint_train_forward(stm, fba, _torch_batch(batch), 4, exact_edt=True)
    np.testing.assert_allclose(got.item(), float(total), rtol=1e-5)
    for k in LOSSES:
        np.testing.assert_allclose(got_aux[k].item(), float(aux[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
