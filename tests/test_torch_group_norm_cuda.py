"""The serving GroupNorm's kernels (otvm_tpu_torch/kernels/csrc/group_norm.cu)
on a CUDA card, against F.group_norm and the activation:

  * at every distinct group-norm shape of a stage-4 frame at 1088x1920
    (tools/bench_group_norm.py frame_shapes: the refinement head's groups
    of 4.18 M values down to the PPM's 1x1 map), with its own activation
    and with each of the others, in bf16 and fp32; at batch 4, at a start
    that is not 16-byte aligned, and at ragged H * W;
  * captured in a CUDA graph and replayed: the eager bits, and `launches`
    counted at each replay, not at the capture;
  * a channels_last input, a wrong dtype or weight, and a capture outside
    record_launches raise; the serving module makes a channels_last input
    NCHW-contiguous first.

Tolerances, each against F.group_norm in fp32 on the same (upcast) values,
rounded once to the dtype: fp32 1e-5 relative (the statistics summed in
another order: the kernels' chunked merge against torch's Welford chain;
mean and rstd agree to ~1e-6); bf16 2^-7 relative, one bf16 ulp (the same
fp32 values rounded once, a value lying within ~1e-6 of a rounding
boundary may round the other way), plus 1e-5 of the largest |value| in
both dtypes for values near zero, where x * a + b cancels.

Needs a card and no JAX:
`python -m pytest --noconftest -m cuda tests/test_torch_group_norm_cuda.py`."""
import pytest
import torch

from otvm_tpu_torch.kernels import group_norm as gn
from otvm_tpu_torch.tools.bench_group_norm import frame_shapes, reference
from otvm_tpu_torch.tools.kernel_check import rel_err

DTYPES = [pytest.param(torch.bfloat16, id="bf16"), pytest.param(torch.float32, id="fp32")]
RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(scope="module")
def shapes():
    return frame_shapes(1088, 1920)


def _inputs(shape, dtype, seed=0, offset=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    numel = 1
    for s in shape:
        numel *= s
    flat = 3.0 + 2.0 * torch.randn(numel + offset, generator=gen, device="cuda")
    x = flat.to(dtype)[offset:].view(shape)
    c = shape[1]
    w = (1.0 + 0.2 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    b = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    return x, w, b


def _check(shape, dtype, act, offset=0):
    groups = min(32, shape[1])
    x, w, b = _inputs(shape, dtype, offset=offset)
    got = gn.group_norm(x, groups, w, b, 1e-5, act)
    want = reference(x, groups, w, b, act)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape and bool(got.isfinite().all())
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=RTOL[dtype], atol=1e-5 * scale)
    return rel_err(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_at_every_frame_shape(shapes, dtype):
    _cuda()
    assert sum(n for _, _, n in shapes) == 66
    gn.launches = 0
    errs = {(shape, a): _check(shape, dtype, a)
            for shape, act, _ in shapes for a in dict.fromkeys([act, None, "relu", "leaky_relu"])}
    assert gn.launches == sum(len({act, None, "relu", "leaky_relu"}) for _, act, _ in shapes)
    print(f"{dtype}: worst norm-relative error {max(errs.values()):.3e} over {len(errs)} cases")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,offset", [((4, 256, 17, 23), 0), ((4, 64, 136, 240), 0),
                                          ((1, 64, 33, 37), 1), ((2, 256, 3, 3), 3),
                                          ((1, 2048, 136, 240), 5), ((3, 96, 5, 7), 0)],
                         ids=["N4-ragged", "N4", "unaligned", "ppm3x3-unaligned",
                              "C2048-unaligned", "G32-D3"])
def test_kernels_at_odd_starts_and_batches(shape, offset, dtype):
    _cuda()
    _check(shape, dtype, "leaky_relu", offset)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_replayed_from_a_cuda_graph(dtype):
    _cuda()
    x, w, b = _inputs((1, 64, 544, 960), dtype)
    eager = gn.group_norm(x, 32, w, b, act="leaky_relu")          # builds; eager first
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    gn.launches = 0
    with gn.record_launches() as norms, torch.cuda.graph(graph, stream=stream):
        out = gn.group_norm(x, 32, w, b, act="leaky_relu")
        out = gn.group_norm(out, 32, w, b)
    assert gn.launches == 0 and len(norms) == 2
    want = gn.group_norm(eager, 32, w, b)
    gn.launches = 0
    for turn in range(3):
        graph.replay()
        gn.count_launches(norms)
        torch.cuda.synchronize()
        assert torch.equal(out, want), turn
    assert gn.launches == 6
    with pytest.raises(RuntimeError, match="outside record_launches"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=stream):
            gn.group_norm(x, 32, w, b)


@pytest.mark.cuda
def test_refusals():
    _cuda()
    x, w, b = _inputs((1, 64, 8, 8), torch.bfloat16)
    with pytest.raises(ValueError, match="NCHW-contiguous"):
        gn.group_norm(x.to(memory_format=torch.channels_last), 32, w, b)
    with pytest.raises(TypeError, match="not supported"):
        gn.group_norm(x.half(), 32, w.half(), b.half())
    with pytest.raises(ValueError, match="weight must be"):
        gn.group_norm(x, 32, w.float(), b)
    with pytest.raises(ValueError, match="groups do not divide"):
        gn.group_norm(x[:, :48].contiguous(), 32, w[:48], b[:48])
    with pytest.raises(RuntimeError, match="no gradient"):
        gn.group_norm(x, 32, w.clone().requires_grad_(True), b)


@pytest.mark.cuda
def test_serving_module_takes_channels_last():
    """A frozen model's norm after a convolution fed a permuted NHWC frame
    gets a channels_last tensor: ServingGroupNorm makes it NCHW-contiguous
    first, as torch's CUDA GroupNorm does."""
    _cuda()
    from otvm_tpu_torch.nn.layers import ServingGroupNorm

    x, w, b = _inputs((1, 64, 40, 24), torch.bfloat16)
    norm = torch.nn.GroupNorm(32, 64).to("cuda", torch.bfloat16)
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
        served = ServingGroupNorm(norm, "relu")
        got = served(x.to(memory_format=torch.channels_last))
        assert got.is_contiguous() and torch.equal(got, served(x))
