"""Port primitives (otvm_tpu_torch.nn.ops / nn.layers) against the JAX
package's, on the same numpy inputs and weights.  fp32 on the CPU; the
tolerances allow for a different summation order only."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from otvm_tpu.nn import layers as jl
from otvm_tpu.nn import ops as jo
from otvm_tpu_torch.nn import layers as tl
from otvm_tpu_torch.nn import ops as to
from tests.torch_port import nchw, nhwc, one_thread  # noqa: F401

ATOL = 1e-5


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("in_hw,out_hw", [((7, 5), (11, 13)), ((9, 9), (4, 6)),
                                          ((5, 7), (10, 14)), ((1, 1), (3, 5))])
def test_resize_bilinear(in_hw, out_hw):
    x = _x((2, *in_hw, 3))
    want = np.asarray(jo.resize_bilinear(jnp.asarray(x), out_hw))
    got = nhwc(to.resize_bilinear(nchw(x), out_hw))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("in_hw,out_hw", [((4, 8), (6, 6)), ((7, 5), (3, 3))])
def test_adaptive_avg_pool(in_hw, out_hw):
    x = _x((2, *in_hw, 4))
    want = np.asarray(jo.adaptive_avg_pool(jnp.asarray(x), out_hw))
    got = nhwc(to.adaptive_avg_pool(nchw(x), out_hw))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("hw", [(7, 9), (8, 5), (13, 13)])
def test_max_pool_3x3_s2(hw):
    x = _x((2, *hw, 3))
    want = np.asarray(jo.max_pool_3x3_s2(jnp.asarray(x)))
    got = nhwc(to.max_pool_3x3_s2(nchw(x)))
    np.testing.assert_array_equal(got, want)


def test_divide_pad_amounts():
    for h, w, d in [(500, 333, 32), (64, 64, 32), (1, 31, 16)]:
        assert to.divide_pad_amounts(h, w, d) == jo.divide_pad_amounts(h, w, d)


def _conv_case(jax_cls, torch_cls, k, stride, pad, dil, bias, linen_child):
    cin, cout = 6, 10
    x = _x((2, 13, 11, cin), 1)
    rng = np.random.RandomState(2)
    kernel = (rng.randn(k, k, cin, cout) / np.sqrt(k * k * cin)).astype(np.float32)
    b = (0.1 * rng.randn(cout)).astype(np.float32)
    p = {"kernel": kernel, **({"bias": b} if bias else {})}
    mod = jax_cls(cout, k, stride, pad, dilation=dil, use_bias=bias)
    want = np.asarray(mod.apply({"params": {"conv": p} if linen_child else p},
                                jnp.asarray(x)))
    tmod = torch_cls(cin, cout, k, stride, pad, dil, bias=bias)
    with torch.no_grad():
        tmod.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        if bias:
            tmod.bias.copy_(torch.from_numpy(b))
        got = nhwc(tmod(nchw(x)))
    return got, want


@pytest.mark.parametrize("k,stride,pad,dil,bias", [
    (3, 1, 1, 1, True), (1, 1, 0, 1, False), (3, 2, 1, 1, False),
    (3, 1, 2, 2, False), (7, 2, 3, 1, False)])
def test_wsconv(k, stride, pad, dil, bias):
    got, want = _conv_case(jl.WSConv, tl.WSConv, k, stride, pad, dil, bias, False)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("k,pad,dil", [(3, 2, 2), (3, 4, 4), (3, 1, 1)])
def test_dilated_conv(k, pad, dil):
    got, want = _conv_case(jl.Conv, tl.Conv, k, 1, pad, dil, True, True)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("c", [16, 64])
def test_groupnorm32(c):
    x = _x((2, 9, 7, c), 3)
    rng = np.random.RandomState(4)
    scale = (1 + 0.2 * rng.randn(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    want = np.asarray(jl.GroupNorm32().apply(
        {"params": {"gn": {"scale": scale, "bias": bias}}}, jnp.asarray(x)))
    gn = tl.GroupNorm32(c)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
        got = nhwc(gn(nchw(x)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_frozen_batchnorm():
    c = 12
    x = _x((2, 5, 6, c), 5)
    rng = np.random.RandomState(6)
    scale, bias, mean = (rng.randn(c).astype(np.float32) for _ in range(3))
    var = (0.5 + rng.rand(c)).astype(np.float32)
    want = np.asarray(jl.FrozenBatchNorm(c).apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean, "var": var}}, jnp.asarray(x)))
    bn = tl.FrozenBatchNorm(c)
    bn.train()  # frozen: train mode must not switch to batch statistics
    with torch.no_grad():
        for name, v in (("weight", scale), ("bias", bias), ("running_mean", mean),
                        ("running_var", var)):
            getattr(bn, name).copy_(torch.from_numpy(v))
        got = nhwc(bn(nchw(x)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_leaky_relu():
    x = _x((3, 4, 5, 2))
    np.testing.assert_array_equal(
        tl.leaky_relu(torch.from_numpy(x)).numpy(), np.asarray(jl.leaky_relu(jnp.asarray(x))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_freeze_for_inference_keeps_outputs(dtype):
    """Folding WSConv standardization and frozen BN once gives the same
    bits as computing them on every call."""
    import copy

    from otvm_tpu_torch.models.otvm import init_models

    stm, fba = init_models(seed=1, stage=4, scale=4)
    rng = np.random.RandomState(7)
    frame = torch.from_numpy(rng.rand(1, 32, 32, 3).astype(np.float32)).to(dtype)
    x11 = torch.from_numpy(rng.randn(1, 32, 32, 11).astype(np.float32)).to(dtype)
    tri = torch.from_numpy(rng.rand(1, 32, 32).astype(np.float32)).to(dtype)
    hid = torch.from_numpy(rng.randn(1, 32, 32, 16).astype(np.float32)).to(dtype)
    with torch.no_grad():
        for net, run in ((fba, lambda m: m(x11, frame, x11[..., -2:])),
                         (stm, lambda m: m.memorize(frame, tri, tri, alpha=tri, hidden=hid))):
            net = net.to(dtype)
            frozen = tl.freeze_for_inference(copy.deepcopy(net))
            assert not any(isinstance(m, (tl.WSConv, tl.FrozenBatchNorm))
                           for m in frozen.modules())
            for a, b in zip(run(net), run(frozen)):
                torch.testing.assert_close(b, a, rtol=0, atol=0)
