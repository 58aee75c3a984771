"""Stage 2 and 3 freezing in the port's trainer (otvm_tpu_torch.train.
trainer) on the CPU, at the scale-4 model and 64x64 crops: RAdam moves
nothing through step 5, then the trained half moves and the frozen half
stays bit for bit (tests/test_torch_trainer.py has the rest of the
trainer)."""
import pytest
import torch

from otvm_tpu_torch.train import trainer as T
from tests.test_torch_trainer import _batches, _cfg, _same, _snapshot
from tests.torch_port import one_thread  # noqa: F401


@pytest.mark.parametrize("stage,frozen", [(2, "stm"), (3, "fba")])
def test_frozen_half_stays_bit_identical(stage, frozen):
    """Steps 1-5 move nothing (RAdam's N_sma < 5); from step 6 the trained
    half moves and the frozen half stays bit for bit."""
    state = T.init_train_state(_cfg(stage), seed=1, device="cpu")
    step = T.make_train_step(_cfg(stage))
    before = {name: _snapshot(getattr(state, name)) for name in ("stm", "fba")}
    trained = "fba" if frozen == "stm" else "stm"
    for i, batch in enumerate(_batches(7, seed=stage, s=2)):
        state, metrics = step(state, batch)
        assert all(torch.isfinite(v) for v in metrics.values())
        assert _same(getattr(state, frozen), before[frozen])
        assert _same(getattr(state, trained), before[trained]) == (i < 5), f"step {i + 1}"
    assert state.step == 7
    assert set(metrics) == {"loss", "L_alpha_comp", "L_lap", "L_grad", "L_tri"}
