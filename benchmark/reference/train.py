"""The reference's stage-4 training step (train.py:305-400 with
models/alpha/model.py:101-312 and utils/optimizer.py): the joint forward
over a clip, the FBA loss stack, the trimap cross-entropies, autograd's
backward and RAdam with decoupled weight decay, in plain fp32 PyTorch on
`nets.py`.  The whole global batch is one process's batch here."""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from .edt import argmax3, trimap_features
from .nets import normalize_image

EPS = 1.001e-5


def decode(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The 8-bit batch (fg, bg, alpha as uint8, the trimap as its label)
    as floats and a one-hot trimap."""
    out = {k: batch[k].float() / 255.0 for k in ("fg", "bg", "alpha")}
    out["tri"] = F.one_hot(batch["tri"].long(), 3).float()
    return out


def l1(x, y, mask=None):
    res = (x - y).abs()
    if mask is None:
        return res.mean()
    n, h, w, c = y.shape
    return (res * mask).sum() / torch.clamp((mask > EPS).float().sum(), EPS, n * c * h * w + 1)


def _grad(img):
    dy = F.pad(img[:, 1:] - img[:, :-1], (0, 0, 0, 0, 0, 1))
    dx = F.pad(img[:, :, 1:] - img[:, :, :-1], (0, 0, 0, 1))
    return dx, dy


def l1_grad(pred, gt):
    fx, fy = _grad(pred)
    tx, ty = _grad(gt)
    return l1(torch.sqrt(fx * fx + fy * fy + EPS), torch.sqrt(tx * tx + ty * ty + EPS))


def exclusion(a, b, level: int = 3):
    gxs, gys = [], []
    for _ in range(level):
        ax1, ay1 = _grad(a)
        ax2, ay2 = _grad(b)
        sx = 2.0 * ax1.abs().mean() / (ax2.abs().mean() + EPS)
        sy = 2.0 * ay1.abs().mean() / (ay2.abs().mean() + EPS)
        g1x, g1y = torch.sigmoid(ax1) * 2 - 1, torch.sigmoid(ay1) * 2 - 1
        g2x, g2y = torch.sigmoid(ax2 * sx) * 2 - 1, torch.sigmoid(ay2 * sy) * 2 - 1
        gxs.append((((g1x ** 2) * (g2x ** 2)).mean(dim=(1, 2, 3)) + EPS) ** 0.25)
        gys.append((((g1y ** 2) * (g2y ** 2)).mean(dim=(1, 2, 3)) + EPS) ** 0.25)
        a = F.avg_pool2d(a.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        b = F.avg_pool2d(b.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    return (sum(gxs) / level).mean() + (sum(gys) / level).mean()


def _gauss(x, scale: float = 1.0):
    """The OpenCV pyrDown 5x5 kernel, reflect padding, depthwise, NCHW."""
    taps = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], dtype=torch.float64)
    k = (torch.outer(taps, taps) / 256.0 * scale).to(x.dtype).to(x.device)
    c = x.shape[1]
    return F.conv2d(F.pad(x, (2, 2, 2, 2), mode="reflect"), k[None, None].expand(c, 1, 5, 5),
                    groups=c)


def lap_loss(diff7, count: int, levels: int = 5):
    """The Laplacian-pyramid term of alpha, F and B (loss_func.py:123-155)
    on their stacked differences [N, H, W, 7], padded to /32 about the
    centre; alpha's plus a quarter of F's and B's means, over `count`."""
    h, w = diff7.shape[1:3]
    nh, nw = h + (32 - h % 32) % 32, w + (32 - w % 32) % 32
    cur = F.pad(diff7.permute(0, 3, 1, 2),
                ((nw - w) // 2, nw - w - (nw - w) // 2, (nh - h) // 2, nh - h - (nh - h) // 2))
    hh, ww = cur.shape[2:]
    sa = sf = sb = 0.0
    for lev in range(levels):
        down = _gauss(cur)[:, :, ::2, ::2]
        up = cur.new_zeros(cur.shape)
        up[:, :, ::2, ::2] = down
        lap = (cur - _gauss(up, 4.0)).abs()
        sa = sa + 2 ** lev * lap[:, 0].sum()
        sf = sf + 2 ** lev * lap[:, 1:4].sum()
        sb = sb + 2 ** lev * lap[:, 4:7].sum()
        cur = down
    d = count * hh * ww
    return sa / d + 0.25 * (sf + sb) / (d * 3.0)


def frame_loss(pred7, trimask, gt, fg, bg, img):
    """fba_single_image_loss without its Laplacian term: (L_alpha_comp,
    L_grad, alpha, F, B)."""
    alpha, pf, pb = pred7[..., 0:1], pred7[..., 1:4], pred7[..., 4:7]
    tm = trimask.bool()
    cf = torch.where(tm & (gt > 0), pf, fg)
    cb = torch.where(tm, pb, bg)
    l_ac = (l1(alpha, gt) + l1(cf * gt + cb * (1 - gt), img)
            + 0.25 * (l1(fg * alpha + bg * (1 - alpha), img) + l1(cf, fg) + l1(cb, bg)))
    l_gr = l1_grad(alpha, gt) + 0.25 * exclusion(cf, cb)
    return l_ac, l_gr, alpha, cf, cb


def cross_entropy(logits, labels):
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))


def joint_loss(stm, fba, batch: Dict[str, torch.Tensor], dtype: Optional[torch.dtype] = None):
    """Stage 4's loss on a decoded batch [B, S, H, W, C]: frame 0 reads the
    GT trimap, each later frame the propagated one (memorize the previous
    frame with its refined alpha, trimap and hidden state, segment over all
    memorized frames, softmax).  dtype: the networks' compute dtype (the
    losses stay fp32).  Returns (total, terms)."""
    fg, bg, gt, tri = batch["fg"], batch["bg"], batch["alpha"], batch["tri"]
    b, s = fg.shape[:2]
    img = fg * gt + bg * (1 - gt)
    img_c = img.to(dtype) if dtype is not None else img
    trimask = (argmax3(tri) == 1).float()[..., None]
    pred_tri = tri[:, 0].to(img_c.dtype)
    outs, routs, logits, rlogits, keys, vals = [], [], [], [], [], []
    for t in range(s):
        feats8, _ = trimap_features(pred_tri)
        x11 = torch.cat([normalize_image(img_c[:, t]), feats8], dim=-1)
        out7, hid, rout7, rtri = fba(x11, img_c[:, t], feats8[..., -2:])
        outs.append(out7)
        routs.append(rout7)
        rlogits.append(rtri)
        if t == s - 1:
            break
        mtri = pred_tri if t == 0 else torch.softmax(rtri, dim=-1)
        k, v = stm.memorize(img_c[:, t], mtri[..., 1], mtri[..., 2], alpha=rout7[..., 0],
                            hidden=hid)
        keys.append(k)
        vals.append(v)
        logits.append(stm.segment(img_c[:, t + 1], torch.stack(keys, 1), torch.stack(vals, 1)))
        pred_tri = torch.softmax(logits[-1], dim=-1)

    def head_terms(preds):
        terms = [frame_loss(preds[t].float(), trimask[:, t], gt[:, t], fg[:, t], bg[:, t],
                            img[:, t]) for t in range(s)]
        l_ac = sum(x[0] for x in terms) / s
        l_gr = sum(x[1] for x in terms) / s
        a, cf, cb = (torch.stack([x[i] for x in terms], 1) for i in (2, 3, 4))
        tc = lambda x, y: (((x[:, 1:] - x[:, :-1]) - (y[:, 1:] - y[:, :-1])) ** 2).mean()
        l_gr = l_gr + tc(a, gt) + 0.25 * (tc(cf, fg) + tc(cb, bg))
        diff = torch.cat([a - gt, cf - fg, cb - bg], dim=-1)
        return l_ac, l_gr, diff.reshape((b * s,) + tuple(diff.shape[2:]))

    ac1, gr1, d1 = head_terms(outs)
    ac2, gr2, d2 = head_terms(routs)
    l_lap = lap_loss(torch.cat([d1, d2], 0), b * s)
    labels = argmax3(tri)
    l_tri = (cross_entropy(torch.stack(logits, 1).float(), labels[:, 1:])
             + cross_entropy(torch.stack(rlogits, 1).float(), labels))
    total = ac1 + ac2 + l_lap + gr1 + gr2 + l_tri
    return total, dict(L_alpha_comp=ac1 + ac2, L_lap=l_lap, L_grad=gr1 + gr2, L_tri=l_tri)


class RAdam:
    """utils/optimizer.py's RAdam (buffer variant) with decoupled weight
    decay, in fp32: no update at all while N_sma < 5 (steps 1-5 at
    beta2 0.999).  lr is constant over the few steps a check runs."""

    def __init__(self, params: List[torch.Tensor], lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.wd, self.betas, self.eps = params, lr, weight_decay, betas, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = self.betas
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
        b2t = b2 ** self.t
        n_max = 2 / (1 - b2) - 1
        n_sma = n_max - 2 * self.t * b2t / (1 - b2t)
        if n_sma < 5:
            return
        rect = math.sqrt((1 - b2t) * (n_sma - 4) / (n_max - 4) * (n_sma - 2) / n_sma
                         * n_max / (n_max - 2)) / (1 - b1 ** self.t)
        for p, m, v in zip(self.params, self.m, self.v):
            p.add_(p, alpha=-self.wd * self.lr)
            p.addcdiv_(m, v.sqrt().add_(self.eps), value=-rect * self.lr)
