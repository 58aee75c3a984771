"""Training losses (NHWC in, fp32 arithmetic), counterpart of
otvm_tpu/train/losses.py, which ports utils/loss_func.py and the FBA loss
stack of models/alpha/model.py:101-187:

  * l1_mask         safe-normalized masked L1
  * l1_grad         gradient-magnitude L1 (eps inside the sqrt)
  * exclusion_loss  multiscale gradient exclusion
  * lap_loss        5-level Laplacian pyramid (the OpenCV pyrDown kernel,
                    reflect padding, zero-interleave upsample)
  * lap_loss_diff7  the same loss for a whole sequence at once: one pyramid
                    of the stacked differences (the pyramid is linear), the
                    gaussian applied as two separable 5-tap passes
  * fba_frame_loss, temporal_coherence_loss, cross_entropy (the trimap CE)
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ..nn.ops import divide_pad_amounts, reflect_pad
from ..parallel.dist import batch_means

EPSILON = 1.001e-5


def l1_mask(x, y, mask=None, normalize=True):
    res = (x - y).abs()
    n, h, w, c = y.shape
    if mask is not None:
        res = res * mask
        if normalize:
            safe = torch.clamp((mask > EPSILON).float().sum(), EPSILON, n * c * h * w + 1)
            return res.sum() / safe
        return res.sum()
    return res.mean() if normalize else res.sum()


def _gradient(img):
    """dx, dy with a trailing zero row/column (utils/loss_func.py:35-42)."""
    dy = F.pad(img[:, 1:] - img[:, :-1], (0, 0, 0, 0, 0, 1))
    dx = F.pad(img[:, :, 1:] - img[:, :, :-1], (0, 0, 0, 1))
    return dx, dy


def l1_grad(pred, gt, mask=None, normalize=True):
    fx, fy = _gradient(pred)
    tx, ty = _gradient(gt)
    mag_f = torch.sqrt(fx * fx + fy * fy + EPSILON)
    mag_t = torch.sqrt(tx * tx + ty * ty + EPSILON)
    return l1_mask(mag_f, mag_t, mask=mask, normalize=normalize)


def _avg_pool_2x2(x):
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def exclusion_loss(img1, img2, level=3, normalize=True, group=None):
    """Multiscale gradient exclusion (utils/loss_func.py).  At each level
    gx2 is scaled by ax = 2 mean|gx1| / mean|gx2| (and gy2 alike): a ratio
    of two means over the whole batch, which in the JAX package's
    data-parallel step is the global batch.  `group`: the data-parallel
    ranks whose rows make up that batch (parallel/dist.py batch_means,
    through which the gradient reaches every rank's rows); None: this
    process holds the whole batch."""
    gradx_loss, grady_loss = [], []
    for _ in range(level):
        gx1, gy1 = _gradient(img1)
        gx2, gy2 = _gradient(img2)
        m_gx1, m_gx2, m_gy1, m_gy2 = batch_means(
            [gx1.abs(), gx2.abs(), gy1.abs(), gy2.abs()], group)
        ax = 2.0 * m_gx1 / (m_gx2 + EPSILON)
        ay = 2.0 * m_gy1 / (m_gy2 + EPSILON)
        gx1s = torch.sigmoid(gx1) * 2 - 1
        gy1s = torch.sigmoid(gy1) * 2 - 1
        gx2s = torch.sigmoid(gx2 * ax) * 2 - 1
        gy2s = torch.sigmoid(gy2 * ay) * 2 - 1
        safe_x = ((gx1s ** 2) * (gx2s ** 2)).mean(dim=(1, 2, 3)) + EPSILON
        safe_y = ((gy1s ** 2) * (gy2s ** 2)).mean(dim=(1, 2, 3)) + EPSILON
        gradx_loss.append(safe_x ** 0.25)
        grady_loss.append(safe_y ** 0.25)
        img1 = _avg_pool_2x2(img1)
        img2 = _avg_pool_2x2(img2)
    gx = sum(gradx_loss) / float(level)
    gy = sum(grady_loss) / float(level)
    if normalize:
        return gx.mean() + gy.mean()
    return gx.sum() + gy.sum()


# ---------------------------------------------------------------------------
# Laplacian pyramid loss (inside: NCHW, so reflect padding is F.pad's)
# ---------------------------------------------------------------------------

_GAUSS_TAPS = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


@functools.lru_cache(maxsize=None)
def _pyr_kernel(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The OpenCV pyrDown 5x5 kernel [1, 1, 5, 5]: outer([1,4,6,4,1])/256."""
    taps = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], dtype=torch.float64)
    return (torch.outer(taps, taps) / 256.0).to(dtype=dtype, device=device)[None, None]


def _conv_gauss(img, scale=1.0):
    """Depthwise 5x5 gaussian with reflect pad 2 (loss_func.py:123-126), NCHW."""
    c = img.shape[1]
    k = (_pyr_kernel(img.dtype, img.device) * scale).expand(c, 1, 5, 5)
    return F.conv2d(reflect_pad(img, (2, 2, 2, 2)), k, groups=c)


def _zero_interleave(x):
    """x at the even rows and columns of a map twice its size, zeros elsewhere."""
    n, c, h, w = x.shape
    up = x.new_zeros((n, c, h * 2, w * 2))
    up[:, :, ::2, ::2] = x
    return up


def _laplacian_pyramid(img, max_levels=5):
    pyr = []
    current = img
    for _ in range(max_levels):
        down = _conv_gauss(current)[:, :, ::2, ::2]
        pyr.append(current - _conv_gauss(_zero_interleave(down), scale=4.0))
        current = down
    return pyr


def lap_loss(img, tgt, mask=None, normalize=True, max_levels=5):
    """utils/loss_func.py:141-155 (pads to /32, center split, first); NHWC."""
    h, w = img.shape[1], img.shape[2]
    lw, uw, lh, uh = divide_pad_amounts(h, w, 32)
    nchw = lambda t: F.pad(t.permute(0, 3, 1, 2), (lw, uw, lh, uh))
    pyr_i = _laplacian_pyramid(nchw(img), max_levels)
    pyr_t = _laplacian_pyramid(nchw(tgt), max_levels)
    nhwc = lambda t: t.permute(0, 2, 3, 1)
    loss = sum((2 ** lev) * l1_mask(nhwc(a), nhwc(b), mask=mask, normalize=False)
               for lev, (a, b) in enumerate(zip(pyr_i, pyr_t)))
    if normalize:
        n, c, hh, ww = pyr_t[0].shape
        safe = (torch.clamp((mask > 1e-6).float().sum(), min=EPSILON)
                if mask is not None else n * c * hh * ww)
        return loss / safe
    return loss


def _gauss_sep(x, scale=1.0):
    """Separable 5x5 gaussian, reflect pad 2, NCHW: _conv_gauss up to fp
    reassociation ([1,4,6,4,1]/16 per axis; the outer product is the /256
    kernel exactly)."""
    for pad, axis in (((0, 0, 2, 2), 2), ((2, 2, 0, 0), 3)):
        xp = reflect_pad(x, pad)
        n = x.shape[axis]
        x = sum(t * xp.narrow(axis, i, n) for i, t in enumerate(_GAUSS_TAPS))
    return x * scale if scale != 1.0 else x


def lap_loss_diff7(diff7, avg_count, max_levels=5):
    """L_lap = L_a_lap + 0.25 * (L_F_lap + L_B_lap), summed over the
    stacked leading axis and divided by `avg_count` (B*S of the per-frame
    calls; refinement-head diffs stacked on too are summed, as the
    reference sums the heads).

    diff7 [N, H, W, 7], channels [alpha - gt | F - fg (3) | B - bg (3)]."""
    h, w = diff7.shape[1], diff7.shape[2]
    lw, uw, lh, uh = divide_pad_amounts(h, w, 32)
    current = F.pad(diff7.permute(0, 3, 1, 2), (lw, uw, lh, uh))
    hh, ww = current.shape[2], current.shape[3]
    s_a = s_f = s_b = torch.zeros((), dtype=diff7.dtype, device=diff7.device)
    for lev in range(max_levels):
        down = _gauss_sep(current)[:, :, ::2, ::2]
        lap = (current - _gauss_sep(_zero_interleave(down), scale=4.0)).abs()
        w_lev = float(2 ** lev)
        s_a = s_a + w_lev * lap[:, 0].sum()
        s_f = s_f + w_lev * lap[:, 1:4].sum()
        s_b = s_b + w_lev * lap[:, 4:7].sum()
        current = down
    denom = avg_count * hh * ww
    return s_a / denom + 0.25 * (s_f + s_b) / (denom * 3.0)


# ---------------------------------------------------------------------------
# FBA per-frame loss stack (models/alpha/model.py:101-187)
# ---------------------------------------------------------------------------

def fba_frame_loss(pred7, trimask, gt_alpha, fg, bg, img, normalize=True,
                   include_lap=True, group=None):
    """One frame of fba_single_image_loss, NHWC, pred7 [B, H, W, 7].
    Returns (L_alpha_comp, L_grad, L_lap, alpha, comp, F, B);
    include_lap=False leaves L_lap 0 for `lap_loss_diff7` to take over.
    group: the data-parallel ranks of the global batch, for the exclusion
    loss's batch means (None: this process holds the whole batch).  The
    other terms are means of per-pixel terms over batches of one shape a
    rank, so the mean over ranks of each rank's value is the global one."""
    alpha = pred7[..., 0:1]
    pred_f = pred7[..., 1:4]
    pred_b = pred7[..., 4:7]

    tmask = trimask.bool()
    c_f = torch.where(tmask & (gt_alpha > 0), pred_f, fg)
    c_b = torch.where(tmask, pred_b, bg)

    comp = c_f * alpha + c_b * (1.0 - alpha)

    L_a1 = l1_mask(alpha, gt_alpha, normalize=normalize)
    ac = c_f * gt_alpha + c_b * (1.0 - gt_alpha)
    L_ac = l1_mask(ac, img, normalize=normalize)
    fbc = fg * alpha + bg * (1.0 - alpha)
    L_FBc = l1_mask(fbc, img, normalize=normalize)
    L_FB1 = l1_mask(c_f, fg, normalize=normalize) + l1_mask(c_b, bg, normalize=normalize)
    L_alpha_comp = L_a1 + L_ac + 0.25 * (L_FBc + L_FB1)

    L_ag = l1_grad(alpha, gt_alpha, normalize=normalize)
    L_excl = exclusion_loss(c_f, c_b, level=3, normalize=normalize, group=group)
    L_grad = L_ag + 0.25 * L_excl

    if include_lap:
        L_lap = (lap_loss(alpha, gt_alpha, normalize=normalize)
                 + 0.25 * (lap_loss(c_f, fg, normalize=normalize)
                           + lap_loss(c_b, bg, normalize=normalize)))
    else:
        L_lap = torch.zeros((), device=pred7.device)
    return L_alpha_comp, L_grad, L_lap, alpha, comp, c_f, c_b


def temporal_coherence_loss(alphas, fgs_pred, bgs_pred, gt_alphas, fgs, bgs):
    """models/alpha/model.py:180-185: MSE of adjacent-frame differences,
    [B, S, H, W, C] each."""
    def tc(x, y):
        return (((x[:, 1:] - x[:, :-1]) - (y[:, 1:] - y[:, :-1])) ** 2).mean()

    return tc(alphas, gt_alphas) + 0.25 * (tc(fgs_pred, fgs) + tc(bgs_pred, bgs))


def argmax_small(x: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis, the first maximum winning ties, as
    jnp.argmax and otvm_tpu's argmax_small (int64 here, for indexing)."""
    best = x[..., 0]
    idx = torch.zeros(best.shape, dtype=torch.int64, device=x.device)
    for k in range(1, x.shape[-1]):
        take = x[..., k] > best
        best = torch.where(take, x[..., k], best)
        idx = torch.where(take, torch.full_like(idx, k), idx)
    return idx


def cross_entropy(logits, labels, ignore_label: Optional[int] = None):
    """nn.CrossEntropyLoss, the mean over pixels not `ignore_label`.
    logits [..., C], labels [...] int.  The stable logsumexp with the class
    axis unrolled, as in the JAX package."""
    chans = [logits[..., k] for k in range(logits.shape[-1])]
    m = chans[0]
    for c in chans[1:]:
        m = torch.maximum(m, c)
    lse = m + torch.log(sum(torch.exp(c - m) for c in chans))
    valid = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    safe_labels = labels
    if ignore_label is not None:
        valid = (labels != ignore_label).float()
        safe_labels = torch.where(labels == ignore_label, torch.zeros_like(labels), labels)
    picked = chans[-1]
    for k in range(len(chans) - 2, -1, -1):
        picked = torch.where(safe_labels == k, chans[k], picked)
    return ((lse - picked) * valid).sum() / torch.clamp(valid.sum(), min=1.0)
