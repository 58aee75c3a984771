"""The port's VM108 metrics (otvm_tpu_torch/eval/metrics.py) against the
JAX package's (otvm_tpu/eval/metrics.py).  Both are numpy, scipy.ndimage
and cv2 on the host, so on the same inputs in one process they agree
exactly: every metric, `video_metrics` and the three IoUs, on seeded clips
at a few sizes, with the unknown-region mask and without.

Also what `messddt` does with cv2's flow: it adds the (dx, dy) flow to
coordinates stacked (y, x), so horizontal motion moves the row index, in
the port as in the JAX package (ROADMAP.md §3, "From the reference side").
"""
import numpy as np
import pytest

from otvm_tpu.eval import metrics as J
from otvm_tpu_torch.eval import metrics as M

SIZES = [(3, 24, 32), (5, 40, 56), (2, 64, 96)]


def _clip(seed, B, H, W):
    """A smooth target matte drifting over the frames (values in [0, 255],
    with saturated regions so the default mask is partial), a prediction
    near it, and the unknown-region mask of the target (128 / 0)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :W]
    frames = []
    for b in range(B):
        cy, cx = H / 2 + 2 * b, W / 2 + 3 * b
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        frames.append(np.clip((0.3 * min(H, W) - d) * 40 + 128, 0, 255))
    target = np.stack(frames).astype(np.float32)
    pred = np.clip(target + rng.randn(B, H, W) * 12, 0, 255).astype(np.float32)
    mask = (((target > 0) & (target < 255)) * 128.0).astype(np.float32)
    mask[:, :2] = 128.0
    return pred, target, mask


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("size", SIZES)
def test_each_metric_equals_jax(size, use_mask):
    pred, target, mask = _clip(sum(size), *size)
    m = mask if use_mask else None
    for name in ("batch_sad", "batch_mse", "batch_gradient", "batch_connectivity"):
        np.testing.assert_array_equal(getattr(M, name)(pred, target, m),
                                      getattr(J, name)(pred, target, m), err_msg=name)
    for name in ("ssda", "dtssd", "messddt"):
        for got, want in zip(getattr(M, name)(pred, target, m), getattr(J, name)(pred, target, m)):
            np.testing.assert_array_equal(got, want, err_msg=name)
    got, want = M.video_metrics(pred, target, m), J.video_metrics(pred, target, m)
    assert got == want
    assert sorted(got) == ["Conn", "Grad", "MESSDdt", "MSE", "SAD", "SSDA", "dtSSD"]
    assert all(np.isfinite(v) for v in got.values())


def test_gauss_kernel_equals_jax():
    for sigma in (1.0, 1.4, 2.0):
        for got, want in zip(M.gen_gauss_kernel(sigma), J.gen_gauss_kernel(sigma)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", SIZES)
def test_ious_equal_jax(size):
    B, H, W = size
    rng = np.random.RandomState(B * H)
    gt = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (B, H, W))]
    pred = rng.dirichlet(np.ones(3), (B, H, W)).astype(np.float32)
    pred[0] = gt[0]                              # a frame that agrees
    lp, lg = pred.argmax(-1), gt.argmax(-1)
    assert M.trimap_iou(pred, gt) == J.trimap_iou(pred, gt)
    assert M.label_iou(lp, lg) == J.label_iou(lp, lg)
    assert M.reference_iou(lp, lg) == J.reference_iou(lp, lg)
    assert M.reference_iou(lp[None], lg[None]) == J.reference_iou(lp[None], lg[None])
    lone = np.zeros((H, W), np.int64)            # classes 1 and 2 absent
    assert M.label_iou(lone, lone) == J.label_iou(lone, lone) == 1.0
    assert M.reference_iou(lone, lone) == J.reference_iou(lone, lone) == 100.0


def _messddt_flow_order(pred, target, flow, xy: bool):
    """messddt's sum with the rounded flow added as given: xy=False adds
    flow[..., 0] to the row (the JAX package's order), xy=True to the column."""
    p, t = pred / 255.0, target / 255.0
    m = ((target > 0) & (target < 255)).astype(np.float32)
    B, h, w = p[:-1].shape
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dy, dx = (flow[..., 1], flow[..., 0]) if xy else (flow[..., 0], flow[..., 1])
    idx = np.clip(yy + dy, 0, h - 1) * w + np.clip(xx + dx, 0, w - 1)
    take = lambda a: np.stack([a[i + 1].reshape(-1)[idx[i].reshape(-1)].reshape(h, w)
                               for i in range(B)])
    err_map = (p[:-1] - t[:-1]) ** 2 * m[:-1] - (take(p) - take(t)) ** 2 * take(m)
    return np.abs(err_map).reshape(B, -1).sum(-1)


def test_messddt_adds_the_horizontal_flow_to_the_row_index():
    """A matte that moves 4 px to the right a frame: cv2's Farneback flow
    is (dx, dy) = (~4, ~0), and messddt warps by it as (row, column), so it
    equals the warp that moves rows by dx, not the one that moves columns."""
    import cv2

    H, W = 48, 64
    yy, xx = np.mgrid[:H, :W]
    target = np.stack([np.clip((10 - np.hypot(yy - 24, xx - 20 - 4 * b)) * 40 + 128, 0, 255)
                       for b in range(3)]).astype(np.float32)
    pred = np.clip(target + 30 * np.sin(xx / 3.0) + 5.0 * np.arange(3)[:, None, None],
                   0, 255).astype(np.float32)
    flows = np.stack([cv2.calcOpticalFlowFarneback(
        target[i].astype(np.uint8), target[i + 1].astype(np.uint8), None,
        0.5, 5, 10, 2, 7, 1.5, cv2.OPTFLOW_FARNEBACK_GAUSSIAN) for i in range(2)])
    flow = np.rint(flows).astype(np.int64)
    moving = target[0] > 0
    assert np.median(flow[0, ..., 0][moving]) >= 3 and np.abs(flow[0, ..., 1][moving]).max() <= 1
    err, _ = M.messddt(pred, target)
    np.testing.assert_array_equal(err, J.messddt(pred, target)[0])
    np.testing.assert_allclose(err, _messddt_flow_order(pred, target, flow, xy=False), rtol=1e-6)
    assert not np.allclose(err, _messddt_flow_order(pred, target, flow, xy=True), rtol=1e-3)
