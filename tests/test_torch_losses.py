"""The port's losses (otvm_tpu_torch.train.losses) against the JAX package's
(otvm_tpu.train.losses), on the same numpy inputs, fp32 on the CPU: values
and gradients.  Tolerances: rtol 1e-5 on values and 1e-5 norm-relative on
gradients, summation order only (the arithmetic is the same); the fused
lap_loss_diff7 is also held to the port's unfused lap_loss, which it
equals up to reassociation (the pyramid is linear)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from otvm_tpu.train import losses as JL
from otvm_tpu_torch.train import losses as TL
from tests.torch_port import one_thread  # noqa: F401

B, H, W = 2, 40, 56     # not multiples of 32: the Laplacian losses pad


def _arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.rand(*s).astype(np.float32) for s in shapes]


def _both(jfn, tfn, arrays, grad_of=0):
    """(jax value, port value, jax grad, port grad) of fn(*arrays), the
    gradient with respect to arrays[grad_of]."""
    jval, jgrad = jax.value_and_grad(lambda *a: jfn(*a), argnums=grad_of)(
        *(jnp.asarray(a) for a in arrays))
    ts = [torch.from_numpy(a) for a in arrays]
    ts[grad_of].requires_grad_()
    tval = tfn(*ts)
    tval.backward()
    return float(jval), tval.item(), np.asarray(jgrad), ts[grad_of].grad.numpy()


def _close(jval, tval, jgrad, tgrad):
    np.testing.assert_allclose(tval, jval, rtol=1e-5, atol=1e-7)
    assert np.linalg.norm(tgrad - jgrad) <= 1e-5 * np.linalg.norm(jgrad) + 1e-12


@pytest.mark.parametrize("use_mask,normalize", [(False, True), (False, False), (True, True),
                                                (True, False)])
def test_l1_mask(use_mask, normalize):
    x, y, mask = _arrays(0, (B, H, W, 3), (B, H, W, 3), (B, H, W, 1))
    mask = (mask > 0.5).astype(np.float32)
    pick = (lambda f: (lambda a, b, m: f(a, b, m if use_mask else None, normalize)))
    _close(*_both(pick(JL.l1_mask), pick(TL.l1_mask), [x, y, mask]))


def test_l1_grad_and_gradient():
    x, y = _arrays(1, (B, H, W, 1), (B, H, W, 1))
    _close(*_both(JL.l1_grad, TL.l1_grad, [x, y]))
    for jg, tg in zip(JL._gradient(jnp.asarray(x)), TL._gradient(torch.from_numpy(x))):
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


@pytest.mark.parametrize("normalize", [True, False])
def test_exclusion_loss(normalize):
    a, b = _arrays(2, (B, H, W, 3), (B, H, W, 3))
    _close(*_both(lambda x, y: JL.exclusion_loss(x, y, normalize=normalize),
                  lambda x, y: TL.exclusion_loss(x, y, normalize=normalize), [a, b]))


@pytest.mark.parametrize("normalize", [True, False])
def test_lap_loss(normalize):
    x, y = _arrays(3, (B, H, W, 3), (B, H, W, 3))
    _close(*_both(lambda a, b: JL.lap_loss(a, b, normalize=normalize),
                  lambda a, b: TL.lap_loss(a, b, normalize=normalize), [x, y]))


def test_lap_loss_diff7_matches_jax_and_the_unfused_loss():
    """The fused loss over a stack of B*S frames (two heads, their sum)
    against JAX's fused loss, and against the port's own per-frame, per-
    quantity lap_loss: sum_t [L(a) + 0.25 (L(F) + L(B))] / (B S) per head."""
    n, heads = 3, 2
    pred, gt = _arrays(4, (heads * n, H, W, 7), (n, H, W, 7))
    diff = pred - np.concatenate([gt] * heads)
    _close(*_both(lambda d: JL.lap_loss_diff7(d, n), lambda d: TL.lap_loss_diff7(d, n), [diff]))
    p, g = torch.from_numpy(pred), torch.from_numpy(np.concatenate([gt] * heads))
    unfused = sum(TL.lap_loss(p[i:i + 1, ..., 0:1], g[i:i + 1, ..., 0:1])
                  + 0.25 * (TL.lap_loss(p[i:i + 1, ..., 1:4], g[i:i + 1, ..., 1:4])
                            + TL.lap_loss(p[i:i + 1, ..., 4:7], g[i:i + 1, ..., 4:7]))
                  for i in range(heads * n)) / n
    fused = TL.lap_loss_diff7(torch.from_numpy(diff), n)
    np.testing.assert_allclose(fused.item(), unfused.item(), rtol=1e-5)


@pytest.mark.parametrize("include_lap", [True, False])
def test_fba_frame_loss(include_lap):
    pred7, gt, fg, bg, tri = _arrays(5, (B, H, W, 7), (B, H, W, 1), (B, H, W, 3), (B, H, W, 3),
                                     (B, H, W, 1))
    trimask = (tri > 0.6).astype(np.float32)
    img = fg * gt + bg * (1 - gt)
    args = [pred7, trimask, gt, fg, bg, img]
    for i in range(3 if include_lap else 2):       # L_alpha_comp, L_grad, L_lap
        _close(*_both(lambda *a: JL.fba_frame_loss(*a, include_lap=include_lap)[i],
                      lambda *a: TL.fba_frame_loss(*a, include_lap=include_lap)[i], args))
    jout = JL.fba_frame_loss(*map(jnp.asarray, args), include_lap=include_lap)
    tout = TL.fba_frame_loss(*map(torch.from_numpy, args), include_lap=include_lap)
    if not include_lap:
        assert tout[2].item() == float(jout[2]) == 0.0
    for j, t in zip(jout[3:], tout[3:]):            # alpha, comp, F, B
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)


def test_temporal_coherence_loss():
    arrays = _arrays(6, *[(B, 3, 16, 24, c) for c in (1, 3, 3, 1, 3, 3)])
    for k in range(3):
        _close(*_both(JL.temporal_coherence_loss, TL.temporal_coherence_loss, arrays, k))


def test_argmax_small_first_max_wins():
    rng = np.random.RandomState(7)
    x = rng.randint(0, 3, (B, H, W, 3)).astype(np.float32)     # many ties
    np.testing.assert_array_equal(TL.argmax_small(torch.from_numpy(x)).numpy(),
                                  np.asarray(JL.argmax_small(jnp.asarray(x))))
    np.testing.assert_array_equal(TL.argmax_small(torch.from_numpy(x)).numpy(), x.argmax(-1))


@pytest.mark.parametrize("ignore", [None, 255])
def test_cross_entropy(ignore):
    rng = np.random.RandomState(8)
    logits = (4 * rng.randn(B, 3, H, W, 3)).astype(np.float32)
    labels = rng.randint(0, 3, (B, 3, H, W))
    if ignore is not None:
        labels[:, :, :8] = ignore
    jval, jgrad = jax.value_and_grad(lambda x: JL.cross_entropy(x, jnp.asarray(labels), ignore))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    tval = TL.cross_entropy(x, torch.from_numpy(labels), ignore)
    tval.backward()
    _close(float(jval), tval.item(), np.asarray(jgrad), x.grad.numpy())
    want = torch.nn.functional.cross_entropy(torch.from_numpy(logits).movedim(-1, 1),
                                             torch.from_numpy(labels),
                                             ignore_index=-100 if ignore is None else ignore)
    np.testing.assert_allclose(tval.item(), want.item(), rtol=1e-5)
