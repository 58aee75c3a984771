"""Port STM (otvm_tpu_torch.models.stm) against the JAX package's: memory
keys and values of `memorize` and the logits of `segment` over a bank with
a masked slot, at scale=4 and 64x64, same weights (convert.stm_from_jax).
fp32 on the CPU; the tolerance is relative to each output's magnitude and
covers summation order through two ResNet trunks."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from otvm_tpu.models.stm import STM as JSTM
from otvm_tpu_torch.convert import stm_from_jax
from otvm_tpu_torch.models.stm import STM
from tests.torch_port import jax_joint_variables, one_thread  # noqa: F401

H = W = 64
SCALE = 4
REL = 1e-4


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, atol=REL * scale, rtol=0, err_msg=what)


@pytest.mark.parametrize("hdim,norm", [(-1, "frozen_bn"), (16, "frozen_bn"), (16, "gn")])
def test_stm_memorize_and_segment(hdim, norm):
    stage = 4 if hdim > 0 else 2
    stm_vars, _ = jax_joint_variables(stage, SCALE, H, W, seed=1, stm_norm=norm)
    jstm = JSTM(hdim=hdim, scale=SCALE, norm=norm)
    tstm = STM(hdim=hdim, scale=SCALE, norm=norm)
    tstm.load_state_dict(stm_from_jax(stm_vars, hdim, SCALE), strict=True)
    tstm.eval()

    rng = np.random.RandomState(2)
    frames = rng.rand(3, 1, H, W, 3).astype(np.float32)
    unknown, fg, alpha = (rng.rand(1, H, W).astype(np.float32) for _ in range(3))
    hidden = rng.randn(1, H, W, 16).astype(np.float32)
    kw_j = dict(alpha=jnp.asarray(alpha), hidden=jnp.asarray(hidden)) if hdim > 0 else {}
    kw_t = dict(alpha=torch.from_numpy(alpha), hidden=torch.from_numpy(hidden)) if hdim > 0 else {}

    jmem = jax.jit(lambda v, f, u, g, **kw: jstm.apply(v, f, u, g, method=JSTM.memorize, **kw))
    keys, vals = [], []
    for i in range(2):
        jk, jv = jmem(stm_vars, jnp.asarray(frames[i]), jnp.asarray(unknown), jnp.asarray(fg),
                      **kw_j)
        with torch.no_grad():
            tk, tv = tstm.memorize(torch.from_numpy(frames[i]), torch.from_numpy(unknown),
                                   torch.from_numpy(fg), **kw_t)
        assert tk.shape == (1, (H // 16) * (W // 16), 128 // SCALE)
        assert tk.is_contiguous() and tv.is_contiguous()
        _close(tk.numpy(), np.asarray(jk), f"key {i}")
        _close(tv.numpy(), np.asarray(jv), f"value {i}")
        keys.append(np.asarray(jk))
        vals.append(np.asarray(jv))

    # bank of 3 slots: the two memories and a masked stale slot
    mk = np.stack(keys + [keys[0] * 3.0], axis=1)
    mv = np.stack(vals + [vals[1] * -2.0], axis=1)
    mask = np.array([[True, True, False]])
    want = np.asarray(jax.jit(lambda v, f, k, m, s: jstm.apply(v, f, k, m, s,
                                                               method=JSTM.segment))(
        stm_vars, jnp.asarray(frames[2]), jnp.asarray(mk), jnp.asarray(mv), jnp.asarray(mask)))
    with torch.no_grad():
        got = tstm.segment(torch.from_numpy(frames[2]), torch.from_numpy(mk),
                           torch.from_numpy(mv), torch.from_numpy(mask)).numpy()
    assert got.shape == (1, H, W, 3)
    _close(got, want, "segment logits")
