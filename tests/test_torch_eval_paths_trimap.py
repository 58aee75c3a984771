"""The trimap-only paths against the JAX package's, fp32 on the CPU at
full width and 32x64: `TrimapEvaluator`, and `trimap_eval_step` with
`memorize_gt` both ways (counts and eviction equal, trimaps within 1e-3 on
frame 0 and to the stream tolerances after; tests/test_torch_eval_paths.py
has the argument)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from otvm_tpu.eval import runner as jrunner  # noqa: E402
from otvm_tpu.models import otvm as jotvm  # noqa: E402
from otvm_tpu_torch.convert import stm_from_jax  # noqa: E402
from otvm_tpu_torch.eval.runner import EvalProtocol, TrimapEvaluator  # noqa: E402
from otvm_tpu_torch.models.otvm import make_eval_bank, trimap_eval_step  # noqa: E402
from tests.test_torch_eval_paths import (H, N, PROTO, W, _labels_agree,  # noqa: E402
                                         _stream_close, _video)
from tests.torch_port import jax_joint_variables, one_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def stm1():
    stm_vars = jax_joint_variables(1, 1, H, W, seed=40)[0]
    return stm_vars, stm_from_jax(stm_vars, hdim=-1)


def test_trimap_evaluator_matches_jax(stm1):
    stm_vars, stm_sd = stm1
    frames, tri = _video(N, 41)
    jt, _ = jrunner.TrimapEvaluator(stm_vars, jrunner.EvalProtocol(**PROTO)).run_video(frames, tri)
    tt, _ = TrimapEvaluator(stm_sd, EvalProtocol(**PROTO), device="cpu").run_video(frames, tri)
    assert len(tt) == len(jt) == N
    np.testing.assert_array_equal(tt[0], tri)
    for i in range(N):
        assert tt[i].shape == (H, W, 3) and tt[i].dtype == np.float32
        _stream_close(tt[i], jt[i], i, "trimap")
        _labels_agree(tt[i], jt[i], i)


@pytest.mark.parametrize("memorize_gt", [False, True])
def test_trimap_eval_step_matches_jax(stm1, memorize_gt):
    """Every frame memorized; a bank of at most 2 and a memorize every 3rd
    frame overflow at frame 3, which evicts slot 1 (slot 0 kept), or slot
    0 with memorize_gt."""
    stm_vars, stm_sd = stm1
    stm = TrimapEvaluator(stm_sd, EvalProtocol(**PROTO), device="cpu").stm
    frames, tri = _video(N, 42)
    flags, max_num, _ = EvalProtocol(**PROTO).flags(N, H, W)
    jbank = jotvm.make_eval_bank(1, H, W, max_num)
    pbank = make_eval_bank(1, H, W, max_num, device="cpu")
    first_keys = None
    for i, (first, mem, _) in enumerate(flags):
        jbank, jpred = jotvm.trimap_eval_step(
            stm_vars, jbank, jnp.asarray(frames[i][None]), jnp.asarray(tri[None]),
            jnp.asarray(first), jnp.asarray(mem), max_memory_num=max_num, memorize_gt=memorize_gt)
        pbank, ppred = trimap_eval_step(stm, pbank, torch.from_numpy(frames[i][None]),
                                        torch.from_numpy(tri[None]), first, mem, max_num,
                                        memorize_gt=memorize_gt)
        assert pbank.count == int(jbank.count), i
        _stream_close(ppred.numpy(), np.asarray(jpred), i, "trimap")
        _labels_agree(ppred.numpy(), np.asarray(jpred), i)
        if first:
            first_keys = pbank.keys[:, 0].clone()
        if memorize_gt:   # the memories are of the GT trimap: the same on both sides
            scale = float(np.abs(np.asarray(jbank.keys)).max())
            np.testing.assert_allclose(pbank.keys[:, :pbank.count].numpy(),
                                       np.asarray(jbank.keys)[:, :pbank.count],
                                       atol=1e-4 * scale, rtol=0)
    assert [f[1] for f in flags[:4]] == [True, False, False, True] and pbank.count == 2
    # frame 3 overflowed: slot 0 is frame 0's memory unless memorize_gt evicted it
    assert torch.equal(pbank.keys[:, 0], first_keys) != memorize_gt
