"""GroupNorm of frozen serving models (otvm_tpu_torch/kernels/group_norm.py)
on the CPU, where the op takes its plain version:

  * the op equals nn.GroupNorm and the activation module after it bit for
    bit, at the stage-4 frame's kinds of shapes (32 groups of 2 channels,
    2048 channels, the PPM's 1x1 and 3x3 maps, batch 1 and 4);
  * freeze_for_inference swaps every nn.GroupNorm of a serving FBA (GN-WS
    with refinement: 66) and of the GN STM trunk for a ServingGroupNorm,
    fuses each LeakyReLU that follows one in an nn.Sequential (its module
    becomes nn.Identity), and leaves a training model's modules alone;
  * a frozen FBA gives the unfrozen module's outputs, calling the op once a
    norm, while a train step calls it never;
  * the op raises on groups that do not divide the channels, the kernel
    wrapper on a CPU tensor; the grid's chunks cover each group.

The kernels themselves are held to F.group_norm on the card:
tests/test_torch_group_norm_cuda.py."""
import copy

import numpy as np
import pytest
import torch
import torch.nn as nn

from otvm_tpu_torch import config
from otvm_tpu_torch.data.loader import encode_wire
from otvm_tpu_torch.kernels import group_norm as gn
from otvm_tpu_torch.models.fba import FBA
from otvm_tpu_torch.models.stm import STM
from otvm_tpu_torch.nn.layers import ServingGroupNorm, freeze_for_inference, init_flax_style
from otvm_tpu_torch.train import trainer as T
from tests.torch_port import one_thread  # noqa: F401

ACTS = [(None, None), ("relu", nn.ReLU()), ("leaky_relu", nn.LeakyReLU(0.01))]


def _x(shape, dtype, seed=0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((3.0 + 2.0 * rng.randn(*shape)).astype(np.float32)).to(dtype)


def _norm(c, dtype, seed=1):
    norm = nn.GroupNorm(min(32, c), c, eps=1e-5)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(1 + 0.2 * rng.randn(c).astype(np.float32)))
        norm.bias.copy_(torch.from_numpy(0.1 * rng.randn(c).astype(np.float32)))
    return norm.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("act,module", ACTS, ids=["none", "relu", "leaky"])
@pytest.mark.parametrize("shape", [(1, 64, 17, 23), (4, 64, 8, 8), (1, 2048, 3, 5),
                                   (1, 256, 1, 1), (4, 256, 3, 3)],
                         ids=["C64-D2", "C64-N4", "C2048", "ppm1x1", "ppm3x3-N4"])
def test_plain_equals_the_modules(shape, act, module, dtype):
    x = _x(shape, dtype)
    norm = _norm(shape[1], dtype)
    with torch.no_grad():
        want = norm(x) if module is None else module(norm(x))
        got = gn.group_norm(x, norm.num_groups, norm.weight, norm.bias, norm.eps, act)
        frozen = ServingGroupNorm(norm, act, 0.01)(x)
    assert torch.equal(got, want) and torch.equal(frozen, want)


def _modules(net, kind):
    return [m for m in net.modules() if isinstance(m, kind)]


def _fba(seed=0):
    fba = FBA(refinement=True)
    init_flax_style(fba, torch.Generator().manual_seed(seed))
    return fba.eval().requires_grad_(False)


def test_freeze_swaps_every_group_norm():
    fba = _fba()
    assert len(_modules(fba, nn.GroupNorm)) == 66
    frozen = freeze_for_inference(copy.deepcopy(fba))
    served = _modules(frozen, ServingGroupNorm)
    assert len(served) == 66 and not _modules(frozen, nn.GroupNorm)
    # the PPM's 4 branches, conv_up1's 2, conv_up2, conv_up3 and the refinement's conv1
    assert sum(m.act == "leaky_relu" for m in served) == 9
    assert all(m.act in (None, "leaky_relu") for m in served)
    for seq in (frozen.decoder.ppm[0], frozen.decoder.conv_up1, frozen.refine.conv1):
        kinds = [type(m) for m in seq]
        i = kinds.index(ServingGroupNorm)
        assert kinds[i + 1] is nn.Identity
    # the activations of conv_up4 and the refinement's pred follow convs: kept
    assert len(_modules(frozen, nn.LeakyReLU)) == len(_modules(fba, nn.LeakyReLU)) - 9
    assert set(frozen.state_dict()) == set(fba.state_dict())      # the norms' names kept

    stm = STM(hdim=16, norm="gn").eval().requires_grad_(False)
    count = len(_modules(stm, nn.GroupNorm))
    assert count > 0
    frozen_stm = freeze_for_inference(stm)
    assert len(_modules(frozen_stm, ServingGroupNorm)) == count
    assert not _modules(frozen_stm, nn.GroupNorm)


def test_training_models_keep_nn_group_norm(monkeypatch):
    """A train state's models are never frozen, and its step never calls
    the op."""
    cfg = config.get_cfg_defaults()
    cfg.train.stage, cfg.model_scale = 4, 4
    state = T.init_train_state(cfg, seed=0, device="cpu")
    for net in (state.fba, state.stm):
        assert not _modules(net, ServingGroupNorm)
    assert _modules(state.fba, nn.GroupNorm)

    def refuse(*args, **kwargs):
        raise AssertionError("the train step called the serving group norm")

    monkeypatch.setattr(gn, "group_norm", refuse)
    rng = np.random.RandomState(0)
    shape = (1, 3, 64, 64)
    batch = encode_wire(dict(fg=rng.rand(*shape, 3), bg=rng.rand(*shape, 3),
                             alpha=rng.rand(*shape, 1), tri=np.eye(3)[rng.randint(0, 3, shape)]))
    _, metrics = T.make_train_step(cfg, graphs=False)(state, batch)
    assert np.isfinite(float(metrics["loss"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_frozen_fba_equals_unfrozen(dtype, monkeypatch):
    fba = _fba(seed=3).to(dtype)
    frozen = freeze_for_inference(copy.deepcopy(fba))
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(1, 32, 48, 11).astype(np.float32)).to(dtype)
    img = torch.from_numpy(rng.rand(1, 32, 48, 3).astype(np.float32)).to(dtype)
    calls = []
    op = gn.group_norm
    monkeypatch.setattr(gn, "group_norm", lambda *a, **k: calls.append(1) or op(*a, **k))
    with torch.no_grad():
        want = fba(x, img, x[..., -2:])
        assert not calls
        got = frozen(x, img, x[..., -2:])
    assert len(calls) == 66
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_raises_where_groups_do_not_divide_channels():
    x = _x((1, 48, 4, 4), torch.float32)
    with pytest.raises(ValueError, match="groups do not divide"):
        gn.group_norm(x, 32)
    with pytest.raises(ValueError, match="unknown activation"):
        gn.group_norm(_x((1, 64, 4, 4), torch.float32), 32, act="gelu")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        gn.group_norm_cuda(_x((1, 64, 4, 4), torch.float32), 32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("groups_total,group_len", [(32, 2 * 1088 * 1920), (32, 64 * 136 * 240),
                                                    (32, 8), (32, 72), (128, 2 * 544 * 960),
                                                    (4, 5)])
def test_chunks_cover_each_group(groups_total, group_len, dtype):
    """Each chunk a multiple of one 16-byte load a thread, none empty, the
    last one ragged; where the groups are long enough, the grid holds
    BLOCKS_PER_SM blocks an SM of 132 SMs, and less than twice that."""
    chunk, chunks = gn.chunking(groups_total, group_len, dtype, 132)
    step = gn.THREADS * 16 // dtype.itemsize
    assert chunk % step == 0 and (chunks - 1) * chunk < group_len <= chunks * chunk
    target = gn.BLOCKS_PER_SM * 132
    if group_len >= step * -(-target // groups_total):
        assert target <= chunks * groups_total < 2 * target + groups_total
    else:
        assert chunk == step


def test_launch_records_do_not_nest_and_count():
    gn.launches = 0
    with gn.record_launches() as norms:
        with pytest.raises(RuntimeError, match="does not nest"):
            with gn.record_launches():
                pass
        norms.extend([1, 1, 1])
    for _ in range(2):
        gn.count_launches(norms)
    assert gn.launches == 6
