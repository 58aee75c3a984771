"""Port distance transforms and click features (otvm_tpu_torch.nn.edt)
against the JAX package's.  The JFA must be bit-exact: same steps, same
neighbour order (each neighbour read from the map the pass's earlier
neighbours updated), same tie-break, integer-exact fp32 distances.  So must
the exact EDT, whose column pass runs over blocks of rows."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from otvm_tpu.nn import edt as jedt
from otvm_tpu_torch.nn import edt as tedt
from tests.torch_port import one_thread  # noqa: F401

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


def _blobs(h, w, cells, seed):
    """A blob-shaped seed map, as a propagated trimap's: a coarse random
    grid, bilinearly upsampled, above 0.5."""
    grid = torch.from_numpy(np.random.RandomState(seed).rand(1, 1, cells, cells).astype(np.float32))
    up = torch.nn.functional.interpolate(grid, size=(h, w), mode="bilinear", align_corners=True)
    return (up[0, 0] > 0.5).numpy()


@pytest.mark.parametrize("h,w,cells,seed", [(128, 128, 10, 2), (128, 128, 10, 5), (45, 70, 5, 2)])
def test_edt_jfa_bit_exact_on_blobs(h, w, cells, seed):
    """Maps on which a JFA that reads all 8 neighbours from the map the
    pass started with ends one pixel at another seed than JAX's."""
    s = _blobs(h, w, cells, seed)
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


@pytest.mark.parametrize("h,w,density,seed", [
    (40, 56, 0.02, 0), (33, 47, 0.01, 1), (17, 90, 0.05, 3), (31, 31, 0.0, 4), (1, 9, 0.3, 5),
    (48, 48, 1.0, 6)])
def test_edt_exact_bit_exact(h, w, density, seed):
    """The exact EDT gives JAX's bits; a map without seeds gives 1e12."""
    s = _seeds(h, w, density, seed)
    want = np.asarray(jedt.edt_sq_exact(jnp.asarray(s)))
    got = tedt.edt_sq_exact(torch.from_numpy(s)[None])[0].numpy()
    np.testing.assert_array_equal(got, want)
    if not s.any():
        assert (got == np.float32(1e12)).all()


@pytest.mark.parametrize("block", [1, 7, 128])
def test_edt_exact_blocked_column_min_is_bit_exact(block):
    """The column pass over blocks of rows smaller than H (and one larger)
    gives JAX's whole-broadcast bits, batched, on blob and sparse maps."""
    maps = np.stack([_blobs(45, 70, 5, 2), _seeds(45, 70, 0.01, 7), _seeds(45, 70, 0.0, 8)])
    got = tedt.edt_sq_exact(torch.from_numpy(maps), block=block).numpy()
    for i in range(len(maps)):
        np.testing.assert_array_equal(got[i], np.asarray(jedt.edt_sq_exact(jnp.asarray(maps[i]))))


def test_make_trimap_features_exact_edt_matches_jax():
    """make_trimap_features(exact_edt=True): the clicks from the exact EDT
    (within fp32 exp's last bits), the soft channels and the trimask
    exactly; a map without fg seeds included."""
    from otvm_tpu.models.otvm import make_trimap_features as jax_features
    from otvm_tpu_torch.models.otvm import make_trimap_features

    rng = np.random.RandomState(11)
    tri = rng.rand(2, 32, 48, 3).astype(np.float32)
    tri[1, ..., 2] = 0.0                             # item 1: no fg seed
    want = jax.jit(jax_features, static_argnames=("exact_edt",))(jnp.asarray(tri), exact_edt=True)
    got = make_trimap_features(torch.from_numpy(tri), exact_edt=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
