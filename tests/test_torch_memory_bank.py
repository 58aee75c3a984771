"""Port memory bank (otvm_tpu_torch.models.memory) against the JAX
package's update_bank: the same flag sequences give the same count and the
same valid slots after every frame."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from otvm_tpu.models import memory as jm
from otvm_tpu_torch.models import memory as tm

HW, CK, CV, N_FRAMES = 4, 8, 16, 16


@pytest.mark.parametrize("keep_first", [True, False])
@pytest.mark.parametrize("max_num,skip", [(0, 3), (1, 3), (2, 3), (5, 4)])
def test_update_bank_matches_jax(max_num, skip, keep_first):
    rng = np.random.RandomState(max_num)
    jbank = jm.init_bank(1, HW, max_num, key_dim=CK, val_dim=CV)
    tbank = tm.init_bank(1, HW, max_num, key_dim=CK, val_dim=CV, device="cpu")
    update = jax.jit(jm.update_bank, static_argnames=("max_memory_num", "keep_first"))
    for i in range(N_FRAMES):
        k = rng.randn(1, HW, CK).astype(np.float32)
        v = rng.randn(1, HW, CV).astype(np.float32)
        first, memorize = i == 0, (i % skip == 0)
        jbank = update(jbank, jnp.asarray(k), jnp.asarray(v), jnp.asarray(first),
                       jnp.asarray(memorize), max_memory_num=max_num, keep_first=keep_first)
        tbank = tm.update_bank(tbank, torch.from_numpy(k), torch.from_numpy(v), first,
                               memorize, max_num, keep_first=keep_first)
        n = int(jbank.count)
        assert tbank.count == n, f"frame {i}"
        np.testing.assert_array_equal(tbank.slot_mask.numpy(), np.asarray(jbank.slot_mask))
        np.testing.assert_array_equal(tbank.keys[:, :n].numpy(), np.asarray(jbank.keys)[:, :n])
        np.testing.assert_array_equal(tbank.values[:, :n].numpy(),
                                      np.asarray(jbank.values)[:, :n])
    assert tbank.count == max(min(max_num, N_FRAMES), 1)
