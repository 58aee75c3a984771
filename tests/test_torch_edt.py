"""Port JFA distance transform and click features (otvm_tpu_torch.nn.edt)
against the JAX package's.  The JFA must be bit-exact: same steps, same
neighbour order, same tie-break, integer-exact fp32 distances."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from otvm_tpu.nn import edt as jedt
from otvm_tpu_torch.nn import edt as tedt

trimap_clicks_jax = jax.jit(jedt.trimap_clicks, static_argnames=("exact",))


def _seeds(h, w, density, seed):
    return np.random.RandomState(seed).rand(h, w) < density


@pytest.mark.parametrize("h,w,density,seed", [
    (40, 56, 0.02, 0), (33, 47, 0.01, 1), (64, 64, 0.002, 2), (17, 90, 0.05, 3),
    (31, 31, 0.0, 4), (1, 9, 0.3, 5), (48, 48, 1.0, 6)])
def test_edt_jfa_bit_exact(h, w, density, seed):
    s = _seeds(h, w, density, seed)
    if density > 0 and not s.any():
        s[h // 2, w // 2] = True
    want = np.asarray(jedt.edt_sq_jfa(jnp.asarray(s)))
    got = tedt.edt_sq_jfa(torch.from_numpy(s)[None])[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_edt_jfa_batched_matches_single():
    maps = np.stack([_seeds(29, 37, d, i) for i, d in enumerate((0.01, 0.0, 0.1))])
    batched = tedt.edt_sq_jfa(torch.from_numpy(maps)).numpy()
    for i in range(len(maps)):
        np.testing.assert_array_equal(
            batched[i], np.asarray(jedt.edt_sq_jfa(jnp.asarray(maps[i]))))


@pytest.mark.parametrize("h,w,seed", [(32, 64, 0), (45, 27, 1)])
def test_trimap_clicks(h, w, seed):
    rng = np.random.RandomState(seed)
    lab = rng.randint(0, 3, (2, h, w))
    lab[1] = 1                                   # second item: no bg/fg seeds
    tri2 = np.stack([lab == 0, lab == 2], axis=-1).astype(np.float32)
    want = np.asarray(trimap_clicks_jax(jnp.asarray(tri2)))
    got = tedt.trimap_clicks(torch.from_numpy(tri2)).numpy()
    assert got.shape == (2, h, w, 6)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
