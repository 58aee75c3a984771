"""Port memory read (otvm_tpu_torch.kernels.memory_attn).

On the CPU: the plain version against the JAX package's XLA path and its
Pallas kernel (interpret mode), fp32, at the JAX tests' shapes.  On a card:
the CUDA kernel against the plain version (skipped without one).  JAX is
imported by the tests that use it, so the card's tests run where JAX is
absent: `python -m pytest --noconftest -m cuda tests/test_torch_memory_attn.py`."""
import numpy as np
import pytest
import torch

from otvm_tpu_torch.kernels import memory_attn as ma

# the JAX tests' shapes (tests/test_memory_attn_pallas.py): (hw, t, mask)
CASES = [(64, 2, None), (96, 3, [1, 1, 0]), (128, 5, [1, 0, 0, 0, 0]), (70, 3, None)]


def _inputs(b, hw, t, seed=0, ck=128, cv=512):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, hw, ck).astype(np.float32),
            rng.randn(b, t, hw, ck).astype(np.float32),
            rng.randn(b, t, hw, cv).astype(np.float32))


def _mask(rows, b):
    return None if rows is None else np.tile(np.asarray(rows, bool)[None], (b, 1))


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from otvm_tpu.kernels.memory_attn import memory_read_pallas, memory_read_xla
    return jnp, memory_read_xla, memory_read_pallas


def _plain(q, k, v, m):
    return ma.memory_read_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                None if m is None else torch.from_numpy(m)).numpy()


@pytest.mark.parametrize("hw,t,rows", CASES)
def test_plain_matches_xla_and_pallas(jx, hw, t, rows):
    jnp, memory_read_xla, memory_read_pallas = jx
    q, k, v = _inputs(2, hw, t)
    m = _mask(rows, 2)
    jm = None if m is None else jnp.asarray(m)
    got = _plain(q, k, v, m)
    xla = np.asarray(memory_read_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm))
    pallas = np.asarray(memory_read_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
                                           block_q=32, block_kv=64, interpret=True))
    np.testing.assert_allclose(got, xla, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("rows", [[0, 0, 0], [0, 1, 0]])
def test_plain_matches_xla_empty_and_non_prefix_mask(jx, rows):
    """No valid slot: the uniform average (Pallas gives NaN there, so XLA
    only).  A non-prefix mask is the general [B, T] form."""
    jnp, memory_read_xla, _ = jx
    q, k, v = _inputs(2, 48, 3, seed=3)
    m = _mask(rows, 2)
    got = _plain(q, k, v, m)
    want = np.asarray(memory_read_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(m)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_plain_bf16_matches_xla(jx):
    jnp, memory_read_xla, _ = jx
    q, k, v = _inputs(1, 64, 2, seed=4)
    m = _mask([1, 1], 1)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = ma.memory_read_plain(bf(q), bf(k), bf(v), torch.from_numpy(m))
    assert got.dtype == torch.bfloat16
    jbf = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = memory_read_xla(jbf(q), jbf(k), jbf(v), jnp.asarray(m))
    # both round p and the output to bf16 (8 bits of mantissa) at
    # different points of their own softmax: a few bf16 ulps of |out| <= ~4
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=3e-2, rtol=2e-2)


def test_wrapper_uses_plain_on_cpu():
    q, k, v = _inputs(1, 32, 2, seed=5)
    before = ma.launches
    got = ma.memory_read(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), None)
    assert ma.launches == before
    np.testing.assert_array_equal(got.numpy(), _plain(q, k, v, None))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ma.memory_read_cuda(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hw,t,rows", [
    (1, 1024, 6, [1, 1, 1, 1, 1, 0]), (1, 1024, 6, [1, 0, 0, 0, 0, 0]),
    (2, 70, 3, [1, 0, 1]), (1, 64, 3, [0, 0, 0])])
def test_kernel_matches_plain_on_cuda(dtype, b, hw, t, rows):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).cuda().to(dt) for a in _inputs(b, hw, t, seed=6))
    m = torch.from_numpy(_mask(rows, b)).cuda()
    before = ma.launches
    got = ma.memory_read(q, k, v, m)
    torch.cuda.synchronize()
    assert ma.launches == before + 1
    want = ma.memory_read_plain(q, k, v, m)
    tol = dict(atol=1e-4, rtol=1e-4) if dt == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
