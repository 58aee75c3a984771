"""The port's data pipeline (otvm_tpu_torch/data/: trimap.py, augs.py,
datasets.py, loader.py) against the JAX package's copies.  Both are numpy
and cv2 on the host, and every random draw comes from the RandomState a
caller passes, so on the same inputs and seeds in one process they agree
exactly: trimap synthesis, each augmentation, DIMTrain and VM108Train
samples on tests/test_data.py's fixtures (written here, same seeds), and
the Loader's batches at 1 and 3 threads.
"""
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from otvm_tpu.data import augs as jaugs
from otvm_tpu.data import datasets as jds
from otvm_tpu.data import loader as jloader
from otvm_tpu.data import trimap as jtrimap
from otvm_tpu_torch.data import augs, datasets, trimap
from otvm_tpu_torch.data.loader import Loader, epoch_indices
from tests.test_data import _circle_alpha, dim_root, vm108_root  # noqa: F401  (fixtures)

CROP = (160, 160)


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("radius", [0, 5, 12, 20])
@pytest.mark.parametrize("eps", [0.0, 0.05])
def test_trimap_from_alpha_equals_jax(radius, eps):
    a = _circle_alpha(96, 120)
    np.testing.assert_array_equal(trimap.trimap_from_alpha(a, radius, eps),
                                  jtrimap.trimap_from_alpha(a, radius, eps))


@pytest.mark.parametrize("close_first", [False, True])
@pytest.mark.parametrize("with_ignore", [False, True])
def test_random_trimap_equals_jax(close_first, with_ignore):
    a = _circle_alpha(96, 120)
    ignore = np.zeros(a.shape, bool)
    ignore[:, :10] = True
    for seed in range(3):
        kw = dict(eps=0.05, close_first=close_first,
                  ignore_region=ignore if with_ignore else None)
        r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
        np.testing.assert_array_equal(trimap.random_trimap_from_alpha(r1, a, **kw),
                                      jtrimap.random_trimap_from_alpha(r2, a, **kw))
        assert r1.randint(1 << 30) == r2.randint(1 << 30)     # the same draws


def test_trimap_from_png_equals_jax():
    g = np.zeros((32, 40), np.uint8)
    g[8:24, 8:30] = 128
    g[12:20, 12:24] = 255
    color = np.zeros((32, 40, 3), np.uint8)
    color[4:20, 4:20, 2] = 255
    color[10:28, 24:36, 1] = 200
    for img in (g, color):
        got = trimap.trimap_from_png(img)
        np.testing.assert_array_equal(got, jtrimap.trimap_from_png(img))
        np.testing.assert_array_equal(got.sum(-1), 1.0)


def _pair(fn, jfn, seed, *args, **kw):
    r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
    got, want = fn(r1, *args, **kw), jfn(r2, *args, **kw)
    assert r1.randint(1 << 30) == r2.randint(1 << 30)
    return got, want


def test_augs_equal_jax():
    rng = np.random.RandomState(0)
    img = rng.rand(48, 64, 3).astype(np.float32) * 255
    ref = (rng.rand(2, 48, 64, 3) * 120 + 100).astype(np.float32)
    mask = (rng.rand(48, 64) > 0.5).astype(np.float32)
    for seed in range(3):
        got, want = _pair(augs.truncated_normal, jaugs.truncated_normal, seed, 1.0, 0.2, 0.5, 1.5)
        assert got == want
        np.testing.assert_array_equal(*_pair(augs.additive_gaussian_noise,
                                             jaugs.additive_gaussian_noise, seed, img, 5.0))
        np.testing.assert_array_equal(*_pair(augs.motion_blur_kernel, jaugs.motion_blur_kernel,
                                             seed, 9))
        stack = np.concatenate([img, img[..., :1]], axis=-1)     # a t-stacked plane
        np.testing.assert_array_equal(*_pair(augs.motion_blur, jaugs.motion_blur, seed, stack))
        kw = dict(rt=25, hs=0.1, ws=0.1, sh=15, zm=(0.9, 1.1), sc=(0.9, 1.0), cs=0.07 * 255,
                  hf=True)
        outs = _pair(lambda r, xs: augs.random_transform(xs, r, **kw),
                     lambda r, xs: jaugs.random_transform(xs, r, **kw), seed, [img, mask])
        for got, want in zip(*outs):
            np.testing.assert_array_equal(got, want)
    for gamma in (0.6, 1.0, 1.4):
        np.testing.assert_array_equal(augs.gamma_contrast(img, gamma),
                                      jaugs.gamma_contrast(img, gamma))
    for comp in (20, 80):
        for x in (img, mask * 255):
            np.testing.assert_array_equal(augs.jpeg_compression(None, x, comp),
                                          jaugs.jpeg_compression(None, x, comp))
    src = rng.rand(2, 48, 64, 3).astype(np.float32) * 200
    np.testing.assert_array_equal(augs.match_histograms(src, ref), jaugs.match_histograms(src, ref))
    for got, want in zip(augs.channel_shift([img, mask], 9.0), jaugs.channel_shift([img, mask], 9.0)):
        np.testing.assert_array_equal(got, want)


def test_dim_samples_equal_jax(dim_root):
    ds = datasets.DIMTrain.from_adobe_layout(dim_root, image_shape=CROP)
    jds_ = jds.DIMTrain.from_adobe_layout(dim_root, image_shape=CROP)
    assert ds.pairs == jds_.pairs and ds.bgs == jds_.bgs and len(ds) == 2
    for idx, seed in ((0, 0), (1, 5), (0, 9)):
        got = ds.__getitem__(idx, np.random.RandomState(seed))
        _same(got, jds_.__getitem__(idx, np.random.RandomState(seed)))
        assert got["fg"].shape == (3, *CROP, 3) and got["tri"].shape == (3, *CROP, 3)
        np.testing.assert_array_equal(got["tri"].sum(-1), 1.0)


def test_vm108_samples_equal_jax(vm108_root):
    ds = datasets.VM108Train(vm108_root, image_shape=CROP, max_skip=3)
    jds_ = jds.VM108Train(vm108_root, image_shape=CROP, max_skip=3)
    assert ds.FG == jds_.FG and ds.BG == jds_.BG
    for idx, seed in ((0, 0), (1, 3)):
        _same(ds.__getitem__(idx, np.random.RandomState(seed)),
              jds_.__getitem__(idx, np.random.RandomState(seed)))
    for epoch in (0, 49, 50, 99, 100, 199):
        assert datasets.vm108_max_skip_for_epoch(epoch) == jds.vm108_max_skip_for_epoch(epoch)


def test_loader_batches_equal_jax_at_1_and_3_threads(dim_root):
    """N threads give the batches of 1 thread, in order, and those are the
    JAX package's Loader's (per-sample RNG keyed on the global position)."""
    ds = datasets.DIMTrain.from_adobe_layout(dim_root, image_shape=CROP)
    jds_ = jds.DIMTrain.from_adobe_layout(dim_root, image_shape=CROP)
    idx = epoch_indices(len(ds), epoch=0, repeats=3, seed=7)
    np.testing.assert_array_equal(idx, jloader.epoch_indices(len(ds), 0, 3, 7))
    want = list(jloader.Loader(jds_, idx, batch_size=2, seed=7, num_threads=1))
    assert len(want) == 3
    for threads in (1, 3):
        loader = Loader(ds, idx, batch_size=2, seed=7, num_threads=threads)
        got = list(loader)
        assert len(got) == len(loader) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
            assert g["fg"].shape == (2, 3, *CROP, 3)


def test_loader_raises_a_workers_error():
    class Boom:
        def __getitem__(self, idx, rnd):
            if idx == 2:
                raise RuntimeError("decode failed")
            return {"x": np.full(2, idx)}

    with pytest.raises(RuntimeError, match="decode failed"):
        list(Loader(Boom(), [0, 1, 2, 3], batch_size=1, num_threads=3))
    got = list(Loader(Boom(), [0, 1, 3, 1], batch_size=2, num_threads=3))
    np.testing.assert_array_equal(got[1]["x"], [[3, 3], [1, 1]])
