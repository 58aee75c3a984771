"""Port FBA (otvm_tpu_torch.models.fba) against the JAX package's:
fba_fusion on the same inputs, and the whole network with refinement off
and on at scale=4, 64x64, same weights (convert.fba_from_jax).  fp32 on the
CPU; tolerances are relative to each output's magnitude: 5e-4 covers
fp32 summation order through the trunk, amplified up to 10x where
fba_fusion divides by sum((F-B)^2) + 0.1."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from otvm_tpu.models import fba as jfba
from otvm_tpu_torch.convert import fba_from_jax
from otvm_tpu_torch.models import fba as tfba
from tests.torch_port import jax_joint_variables, one_thread  # noqa: F401

H = W = 64
SCALE = 4


def test_fba_fusion_exact():
    rng = np.random.RandomState(0)
    alpha = rng.rand(2, 9, 7, 1).astype(np.float32)
    img, F, B = (rng.rand(2, 9, 7, 3).astype(np.float32) for _ in range(3))
    want = jfba.fba_fusion(*(jnp.asarray(a) for a in (alpha, img, F, B)))
    got = tfba.fba_fusion(*(torch.from_numpy(a) for a in (alpha, img, F, B)))
    for g, w, name in zip(got, want, ("alpha", "F", "B")):
        # same elementwise formula; XLA may contract a*b+c into an FMA
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0, err_msg=name)


@pytest.mark.parametrize("refinement", [False, True])
def test_fba_forward(refinement):
    stage = 4 if refinement else 2
    _, fba_vars = jax_joint_variables(stage, SCALE, H, W, seed=3)
    jmod = jfba.FBA(refinement=refinement, scale=SCALE)
    tmod = tfba.FBA(refinement=refinement, scale=SCALE)
    tmod.load_state_dict(fba_from_jax(fba_vars, refinement, SCALE), strict=True)
    tmod.eval()

    rng = np.random.RandomState(4)
    img = rng.rand(1, H, W, 3).astype(np.float32)
    x11 = np.concatenate([rng.randn(1, H, W, 3), rng.rand(1, H, W, 8)], -1).astype(np.float32)
    tri2 = x11[..., -2:]
    want = jax.jit(jmod.apply)(fba_vars, jnp.asarray(x11), jnp.asarray(img), jnp.asarray(tri2))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x11), torch.from_numpy(img), torch.from_numpy(tri2))
    names = ("output7", "hid16", "refine_output7", "refine_trimap3")
    for g, w, name in zip(got, want, names):
        if not refinement and name.startswith("refine"):
            assert g is None and w is None
            continue
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g.numpy(), w, atol=5e-4 * scale, rtol=0, err_msg=name)
