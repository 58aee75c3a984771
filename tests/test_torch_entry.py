"""The port's entry points of __graft_entry__.py (otvm_tpu_torch/entry.py)
on the CPU:
`entry` against __graft_entry__.py's on the same weights (seeded JAX
variables, carried by convert.from_jax), and the two dry runs as 2 gloo
ranks, each on one thread, with the models at scale 4 (as the JAX dry
runs' OTVM_DRYRUN_SCALE=4; chip_smoke.py phase 9 runs them at full width).

entry's frame reads the GT trimap (frame 0 of a stream).  On a seeded
smooth frame with the nested-box trimap, alpha and trimap values lie
within 1e-3 of JAX's, as frame 0 in tests/test_torch_stream.py (fp32
summation order, amplified up to 10x where fba_fusion divides by
sum((F-B)^2) + 0.1), but that test's frames are 32x64: at 256x256 the
full-width sums are longer, and 13 of the 65536 alphas lie up to 1.52e-3
apart.  So at most 0.1% of values may lie beyond 1e-3, and none beyond
1e-2.  The example arguments are a zero frame: every GroupNorm group of
the first layers then has zero variance and divides fp32 noise by
sqrt(eps), so the two frameworks' outputs part (measured: ~8% of alphas
more than 1e-3 apart, at most 0.52); there the check is shapes, dtypes
and finite values in range.  JAX's function runs eagerly: jit
constant-folds its closure's full-width weights for a minute.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import __graft_entry__ as graft
from otvm_tpu.train.trainer import TrainState
from otvm_tpu_torch import entry as E
from otvm_tpu_torch.convert import from_jax
from tests.test_torch_stream import _video
from tests.torch_port import jax_joint_variables, one_thread  # noqa: F401


def test_entry_matches_jax(monkeypatch):
    stm_vars, fba_vars = jax_joint_variables(4, 1, 64, 64, seed=7)
    state = TrainState({"stm": stm_vars["params"], "fba": fba_vars["params"]},
                       stm_vars["batch_stats"], None, np.zeros((), np.int32))
    monkeypatch.setattr(graft, "_tiny_state", lambda *args, **kwargs: (None, None, state))
    jfn, jargs = graft.entry()
    fn, args = E.entry(device="cpu", weights=from_jax(stm_vars, fba_vars, stage=4))
    for got, want in zip(args[:2], jargs[:2]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert args[2:] == tuple(bool(x) for x in jargs[2:])
    for a, t in (fn(*args), jfn(*jargs)):
        a, t = np.asarray(a), np.asarray(t)
        assert a.shape == (1, 256, 256, 1) and t.shape == (1, 256, 256, 3)
        assert a.dtype == t.dtype == np.float32 and np.isfinite(a).all() and np.isfinite(t).all()
        assert 0.0 <= a.min() and a.max() <= 1.0

    frames, tri = _video(256, 256, 1, seed=3)
    frame, tri = frames[0][None], tri[None]
    alpha, trimap = (x.numpy() for x in fn(torch.from_numpy(frame), torch.from_numpy(tri),
                                            *args[2:]))
    jfn = graft.entry()[0]          # JAX's step donates its closure's bank: a fresh one
    j_alpha, j_trimap = (np.asarray(x) for x in jfn(frame, tri, *jargs[2:]))
    for got, want, what in ((alpha, j_alpha, "alpha"), (trimap, j_trimap, "trimap")):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2, err_msg=what)
        off = (np.abs(got - want) > 1e-3).mean()
        assert off <= 1e-3, f"{what}: {off:.3%} of values off by more than 1e-3"
    # each call starts from an empty bank, as JAX's pure function does
    assert torch.equal(fn(torch.from_numpy(frame), torch.from_numpy(tri), *args[2:])[0],
                       torch.from_numpy(alpha))


def test_dryrun_multichip_two_ranks():
    results = E.dryrun_multichip(2, device="cpu", scale=4)
    assert [r["rank"] for r in results] == [0, 1]
    assert all(r["backend"] == "gloo" and r["ranks_equal"] for r in results)
    loss = results[0]["loss"]
    assert np.isfinite(loss) and results[1]["loss"] == loss
    # the global batch's loss is the mean of the ranks' rows' losses
    np.testing.assert_allclose(loss, np.mean([r["rank_loss"] for r in results]), rtol=1e-6)
    assert results[0]["rank_loss"] != results[1]["rank_loss"]


def test_dryrun_multichip_eval_two_ranks():
    results = E.dryrun_multichip_eval(2, device="cpu", scale=4)
    assert all(r["isolated"] and r["identical"] and r["backend"] == "gloo" for r in results)
    with pytest.raises(ValueError, match="two streams"):
        E.dryrun_multichip_eval(1, device="cpu", scale=4)


def test_entry_points_need_cuda_by_default(monkeypatch):
    """No card: each entry point raises before it spawns a rank, unless
    asked for the CPU."""
    from otvm_tpu_torch.tools import ddp_check, multistream_bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (E.entry, lambda: E.dryrun_multichip(2), lambda: E.dryrun_multichip_eval(2),
                 lambda: ddp_check.run(2), lambda: multistream_bench.main(["--frames", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
