"""The port's BN FBA trunk (otvm_tpu_torch.nn.resnet_bn, FBA(arch=
"resnet50_BN")) against the JAX package's, with the same numpy-seeded
weights carried by convert.from_jax, fp32 on the CPU at 32x32 (the trunk
has no width-scaled variant, in either package).

  * The trunk's pyramid: shapes, and each level within 1e-4 of its largest
    value (fp32 summation order through 50 convolutions).
  * FBA with refinement: every output within 1e-3 of its largest value
    (test_torch_fba.py's argument: fba_fusion's division amplifies fp32
    noise up to 10x).
  * The converter: from_jax / to_jax round-trip exactly and strictly.
  * freeze_for_inference folds BNAffine without moving a bit.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from otvm_tpu.models import fba as jfba
from otvm_tpu.nn.resnet_bn import ResNet50DilatedBN as JTrunk
from otvm_tpu_torch import convert
from otvm_tpu_torch.models import fba as tfba
from otvm_tpu_torch.nn.layers import freeze_for_inference
from otvm_tpu_torch.nn.resnet_bn import BNAffine
from tests.torch_port import random_variables, one_thread  # noqa: F401

H = W = 32
ARCH = "resnet50_BN"


def _inputs(seed):
    rng = np.random.RandomState(seed)
    img = rng.rand(1, H, W, 3).astype(np.float32)
    x11 = np.concatenate([rng.randn(1, H, W, 3), rng.rand(1, H, W, 8)], -1).astype(np.float32)
    return x11, img, x11[..., -2:]


@pytest.fixture(scope="module")
def fba_vars():
    """Numpy-seeded variables of the JAX FBA on the BN trunk, refinement on."""
    x11, img, tri2 = (jnp.asarray(a) for a in _inputs(0))
    shapes = jax.eval_shape(lambda: jfba.FBA(refinement=True, arch=ARCH).init(
        jax.random.PRNGKey(0), x11, img, tri2))
    return {"params": random_variables(shapes["params"], np.random.RandomState(1))}


def _port_fba(fba_vars):
    net = tfba.FBA(refinement=True, arch=ARCH)
    net.load_state_dict(convert.fba_from_jax(fba_vars, True, arch=ARCH), strict=True)
    return net.eval()


def _close(got, want, tol, what):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol * scale, rtol=0, err_msg=what)


def test_trunk_pyramid_matches_jax(fba_vars):
    x11 = _inputs(2)[0]
    want = jax.jit(JTrunk().apply)({"params": fba_vars["params"]["encoder"]}, jnp.asarray(x11))
    with torch.no_grad():
        got = _port_fba(fba_vars).encoder(torch.from_numpy(x11).permute(0, 3, 1, 2))
    channels = [11, 128, 256, 512, 1024, 2048]
    strides = [1, 2, 4, 8, 8, 8]
    for level, (g, w, c, s) in enumerate(zip(got, want, channels, strides)):
        assert tuple(g.shape) == (1, c, H // s, W // s), level
        _close(g.permute(0, 2, 3, 1), w, 1e-4, f"level {level}")


def test_fba_bn_matches_jax(fba_vars):
    x11, img, tri2 = _inputs(3)
    want = jax.jit(jfba.FBA(refinement=True, arch=ARCH).apply)(
        fba_vars, jnp.asarray(x11), jnp.asarray(img), jnp.asarray(tri2))
    net = _port_fba(fba_vars)
    with torch.no_grad():
        got = net(*(torch.from_numpy(a) for a in (x11, img, tri2)))
    for g, w, name in zip(got, want, ("output7", "hid16", "refine_output7", "refine_trimap3")):
        _close(g, w, 1e-3, name)
    # serving folds every BNAffine into an affine of the same arithmetic
    frozen = freeze_for_inference(_port_fba(fba_vars))
    assert not any(isinstance(m, BNAffine) for m in frozen.modules())
    with torch.no_grad():
        again = frozen(*(torch.from_numpy(a) for a in (x11, img, tri2)))
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_converter_round_trips_the_bn_trunk_exactly(fba_vars):
    sd = convert.fba_from_jax(fba_vars, True, arch=ARCH)
    assert "encoder.conv3.weight" in sd and "encoder.layer4.0.downsample.1.weight" in sd
    assert not any(k.endswith("running_mean") for k in sd)
    back = convert._apply_to_jax(sd, convert.fba_table(True, 1, ARCH))
    for path, leaf in jax.tree_util.tree_leaves_with_path(fba_vars):
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf, err_msg=jax.tree_util.keystr(path))
    n_leaves = len(jax.tree_util.tree_leaves(fba_vars))
    assert len(jax.tree_util.tree_leaves(back)) == n_leaves == len(sd)
    # strict both ways: the GN-WS table takes none of it
    with pytest.raises(KeyError):
        convert.fba_from_jax(fba_vars, True)
    with pytest.raises(KeyError):
        convert._apply_to_jax(dict(sd, stray=torch.zeros(1)), convert.fba_table(True, 1, ARCH))


def test_unknown_arch_and_scaled_bn_raise():
    with pytest.raises(KeyError, match="unknown FBA arch"):
        tfba.FBA(arch="resnet18_GN_WS")
    with pytest.raises(KeyError):
        convert.fba_table(True, 1, "resnet18_GN_WS")
    with pytest.raises(KeyError):
        jfba.ENCODER_ARCHS["resnet18_GN_WS"]
    # no width-scaled BN trunk: JAX fails on the trunk's `width`, the port alike
    with pytest.raises(TypeError):
        tfba.FBA(arch=ARCH, scale=4)
    with pytest.raises(TypeError):
        JTrunk(width=16)


def test_bn_trunk_trains_and_serves_from_config():
    """init_train_state builds the BN trunk from cfg.alpha.arch, and
    load_pth refuses a checkpoint of it (the reference ships none)."""
    from otvm_tpu_torch import config
    from otvm_tpu_torch.train.trainer import init_train_state

    cfg = config.get_cfg_defaults()
    cfg.train.stage, cfg.model_scale, cfg.alpha.arch = 1, 4, ARCH
    with pytest.raises(TypeError):
        init_train_state(cfg, device="cpu")       # scale 4: no such trunk
    cfg.model_scale = 1
    state = init_train_state(cfg, device="cpu")
    assert state.fba.arch == ARCH and isinstance(state.fba.encoder.bn1, BNAffine)
    assert state.fba.decoder.conv_up3[0].in_channels == 256 + 128
    torch.testing.assert_close(state.fba.encoder.bn1.weight, torch.ones(64))
