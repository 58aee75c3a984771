"""`alpha_predict` (stages 1 and 2, the given-trimap path) and the
stage-1/2 `StreamingEvaluator` against the JAX package's, fp32 on the CPU
at full width and 32x64 (tests/test_torch_eval_paths.py has the argument
and the tolerances)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from otvm_tpu.eval import runner as jrunner  # noqa: E402
from otvm_tpu.models import otvm as jotvm  # noqa: E402
from otvm_tpu_torch.convert import fba_from_jax  # noqa: E402
from otvm_tpu_torch.eval.runner import EvalProtocol, StreamingEvaluator  # noqa: E402
from otvm_tpu_torch.models.otvm import alpha_predict, init_models  # noqa: E402
from tests.test_torch_eval_paths import H, W, _u8, _video  # noqa: E402
from tests.torch_port import jax_joint_variables, one_thread  # noqa: E402,F401


@pytest.mark.parametrize("stage", [1, 2])
def test_alpha_predict_matches_jax(stage):
    _, fba_vars = jax_joint_variables(stage, 1, H, W, seed=30 + stage)
    frames, tri = _video(3, 31)
    gts = [tri, tri[:, ::-1].copy(), np.roll(tri, 5, axis=1)]
    jev = jrunner.StreamingEvaluator(None, fba_vars, jrunner.EvalProtocol(stage=stage))
    ja, jt, _ = jev.run_video(frames, tri, gt_trimaps=gts)
    ev = StreamingEvaluator(None, fba_from_jax(fba_vars, refinement=False),
                            EvalProtocol(stage=stage), device="cpu")
    ta, tt, _ = ev.run_video(frames, tri, gt_trimaps=gts)
    assert len(ta) == len(ja) == 3 and len(tt) == 3
    for i in range(3):
        np.testing.assert_allclose(ta[i], ja[i], atol=1e-3, rtol=0)
        assert tt[i] is gts[i]                       # the given trimaps come back
    # the step itself, on a soft trimap: alpha and all 7 channels
    soft = np.random.RandomState(32).dirichlet(np.ones(3), (1, H, W)).astype(np.float32)
    u8 = _u8(frames[:1])
    ja1, j7 = jotvm.alpha_predict(fba_vars, jnp.asarray(u8), jnp.asarray(soft), stage=stage)
    ta1, t7 = alpha_predict(ev.fba, torch.from_numpy(u8), torch.from_numpy(soft))
    assert ta1.shape == (1, H, W, 1) and t7.shape == (1, H, W, 7)
    np.testing.assert_allclose(ta1.numpy(), np.asarray(ja1), atol=1e-3, rtol=0)
    np.testing.assert_allclose(t7.numpy(), np.asarray(j7), atol=1e-3, rtol=0)


def test_stage_1_2_runs_without_a_trimap_state():
    """No trimap network at stages 1-2: None or {} for its state; without
    per-frame trimaps only frame 0 (whose trimap is given) runs."""
    _, fba = init_models(seed=3, stage=2, scale=4)
    frames, tri = _video(3, 33, 64, 64)
    for state in (None, {}):
        ev = StreamingEvaluator(state, fba.state_dict(), EvalProtocol(stage=2, scale=4),
                                device="cpu")
        assert ev.stm is None
        alphas, trimaps, _ = ev.run_video(frames, tri)
        assert len(alphas) == 1 and trimaps[0] is tri
        assert alphas[0].shape == (64, 64) and 0.0 <= alphas[0].min() <= alphas[0].max() <= 1.0
        alphas, _, _ = ev.run_video(frames, tri, gt_trimaps=[tri] * 5)
        assert len(alphas) == 3
